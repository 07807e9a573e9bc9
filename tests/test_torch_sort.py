"""Field sort and ``search_after`` of the PyTorch port against the
reference, on the CPU.

Inputs: ``tests/_torch_parity.py::agg_corpus`` (a long, an integer, a
double, a date, a keyword and a multi-valued keyword, each missing from
some docs) with a unique ``seq`` (a search_after walk needs a tuple no
two docs share), 300 docs indexed by both packages into three shards of
two segments. The port's mesh path and host loop are held against the
reference's host loop and its 8-device CPU mesh (its AOT cache patched
off at run time, as in ``test_torch_mesh.py``), and against each other
byte for byte: the whole response's JSON apart from ``took``.

The port's sort is exact; the reference preselects on the primary key in
f32 and drops what that cuts (ROADMAP C, "Reference fault, field sort").
Each of its three faults has a test that shows the reference's answer
and holds the port's to an ``np.lexsort`` oracle over the documents'
own values; every other body must equal the reference.
"""
import copy
import json

import numpy as np
import pytest

from elasticsearch_tpu.monitor import kernels as ref_kernels
from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu.search.service import \
    _after_cursor as ref_after_cursor
from elasticsearch_tpu_torch.monitor import kernels
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops import scoring
from elasticsearch_tpu_torch.utils.errors import SearchParseException

from _torch_parity import AGG_MAPPING, agg_corpus

N_DOCS = 300
SHARDS = 3
QUERY = {"match": {"body": "fox dog river quick lazy"}}
MAPPING = {"properties": dict(AGG_MAPPING["properties"],
                              seq={"type": "long"})}


def _corpus():
    return [(doc_id, dict(src, seq=i))
            for i, (doc_id, src) in enumerate(agg_corpus(N_DOCS, seed=5))]


@pytest.fixture(autouse=True)
def _no_reference_aot_cache(monkeypatch):
    from elasticsearch_tpu.parallel import aot

    monkeypatch.setattr(aot, "_ENABLED", False)


def _load(nodes, name, mapping, docs, shards=SHARDS, refreshes=2):
    body = {"settings": {"index": {"number_of_shards": shards}},
            "mappings": mapping}
    step = -(-len(docs) // refreshes)
    for node in nodes:
        node.create_index(name, copy.deepcopy(body))
        for a in range(0, len(docs), step):
            for doc_id, src in docs[a: a + step]:
                node.index(name, doc_id, copy.deepcopy(src))
            node.refresh(name)


@pytest.fixture(scope="module")
def nodes():
    from elasticsearch_tpu.parallel import aot

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(aot, "_ENABLED", False)
        ref = RefNode(name="ref")
        port = Node(name="port", device="cpu")
        _load([_RefIndexer(ref), port], "s", MAPPING, _corpus())
    yield ref, port
    ref.close()
    port.close()


class _RefIndexer:
    """The reference node behind the port Node's create/index/refresh
    calls (its Node.index takes other keywords)."""

    def __init__(self, ref):
        self.ref = ref

    def create_index(self, name, body):
        self.ref.create_index(name, body)

    def index(self, name, doc_id, src):
        self.ref.indices[name].index_doc(doc_id, src)

    def refresh(self, name):
        self.ref.indices[name].refresh()


def _json(resp) -> str:
    r = dict(resp)
    r.pop("took", None)
    r.pop("_scroll_id", None)
    return json.dumps(r, sort_keys=True)


def _port(port, index, body, monkeypatch, mesh: bool):
    """The port's answer on one route, asserting the route."""
    if not mesh:
        monkeypatch.setenv("ESTPU_DISABLE_MESH", "1")
    kernels.reset()
    resp = port.search(index, copy.deepcopy(body))
    snap = kernels.snapshot()
    monkeypatch.delenv("ESTPU_DISABLE_MESH", raising=False)
    if mesh:
        assert snap.get("mesh_search") == 1, snap
        assert not snap.get("mesh_fallback_total"), snap
    else:
        assert not any(k.startswith("mesh_") for k in snap), snap
    return resp


def _ref(ref, index, body, monkeypatch, mesh: bool):
    if not mesh:
        monkeypatch.setenv("ESTPU_DISABLE_MESH", "1")
    ref_kernels.reset()
    resp = ref.search(index, copy.deepcopy(body))
    snap = ref_kernels.snapshot()
    monkeypatch.delenv("ESTPU_DISABLE_MESH", raising=False)
    assert bool(snap.get("mesh_search")) == mesh, snap
    return resp


def _ids(resp):
    return [h["_id"] for h in resp["hits"]["hits"]]


BODIES = {
    "long_asc": {"sort": [{"n": "asc"}], "size": 25},
    "long_desc_from": {"sort": [{"n": {"order": "desc"}}], "size": 20,
                       "from": 15},
    "integer_then_long": {"sort": [{"qty": "desc"}, {"n": "asc"}],
                          "size": 30},
    "double_desc_query": {"query": QUERY, "sort": [{"price": "desc"}],
                          "size": 12},
    "double_asc_keyword": {"sort": [{"price": "asc"}, "tag"], "size": 18},
    "date_desc": {"sort": [{"ts": {"order": "desc"}}], "size": 20},
    "date_asc_from": {"query": QUERY, "sort": ["ts"], "size": 10,
                      "from": 7},
    "keyword_three_keys": {"sort": ["tag", {"qty": "desc"}, {"ts": "asc"}],
                           "size": 40},
    "keyword_desc_double": {"sort": [{"tag": "desc"}, {"price": "asc"}],
                            "size": 25},
    "multi_valued_keyword": {"sort": ["labels", "n"], "size": 20},
    "ip_secondary": {"sort": ["tag", {"addr": "desc"}], "size": 15},
    "range_filtered": {"query": {"range": {"qty": {"gte": 5, "lt": 15}}},
                       "sort": [{"ts": "desc"}], "size": 30,
                       "_source": ["ts", "qty"]},
}
#: bodies the mesh declines (``_score`` as a key): the host loop serves
#: them, the reference's mesh as well
HOST_ONLY = {
    "score_secondary": {"query": QUERY, "sort": ["tag", "_score"],
                        "size": 20},
    "score_asc_primary": {"query": QUERY,
                          "sort": [{"_score": "asc"}, {"n": "desc"}],
                          "size": 15},
}


@pytest.mark.parametrize("name", sorted(BODIES))
def test_sort_matches_reference_on_both_routes(nodes, name, monkeypatch):
    ref, port = nodes
    body = BODIES[name]
    mesh = _port(port, "s", body, monkeypatch, mesh=True)
    host = _port(port, "s", body, monkeypatch, mesh=False)
    assert mesh["hits"]["hits"] and mesh["hits"]["max_score"] is None
    assert all(h["_score"] is None and "sort" in h
               for h in mesh["hits"]["hits"])
    assert _json(mesh) == _json(host)
    assert _json(host) == _json(_ref(ref, "s", body, monkeypatch, False))
    assert _json(mesh) == _json(_ref(ref, "s", body, monkeypatch, True))


@pytest.mark.parametrize("name", sorted(HOST_ONLY))
def test_score_sort_keys_take_the_host_loop(nodes, name, monkeypatch):
    ref, port = nodes
    body = HOST_ONLY[name]
    kernels.reset()
    got = port.search("s", copy.deepcopy(body))
    snap = kernels.snapshot()
    assert snap.get("mesh_fallback_total") == 1 and not snap.get(
        "mesh_search"), snap
    assert _json(got) == _json(_port(port, "s", body, monkeypatch, False))
    assert _json(got) == _json(_ref(ref, "s", body, monkeypatch, False))


def test_ip_primary_rides_the_mesh(nodes, monkeypatch):
    """The reference's mesh declines an ip primary; the port's sorts its
    column, as the host loops of both do."""
    ref, port = nodes
    body = {"sort": [{"addr": "asc"}, "ts"], "size": 15}
    mesh = _port(port, "s", body, monkeypatch, mesh=True)
    assert _json(mesh) == _json(_port(port, "s", body, monkeypatch, False))
    assert _json(mesh) == _json(_ref(ref, "s", body, monkeypatch, False))


# -- the np.lexsort oracle ---------------------------------------------------

def _positions(port, index):
    """doc id -> (shard, segment ordinal, local id) of every live doc."""
    out = {}
    for sh, shard in enumerate(port.get_index(index).shards):
        for so, seg in enumerate(shard.segments):
            for local, doc_id in enumerate(seg.ids):
                if seg.live_host[local]:
                    out[doc_id] = (sh, so, local)
    return out


def _first(v):
    return v[0] if isinstance(v, list) else v


def oracle(docs, positions, spec, scores=None):
    """The doc ids in ES order by ``np.lexsort``: per key a missing rank
    (0 first, 1 present, 2 last) and the value's rank among the distinct
    values (negated for descending), then shard, segment, local."""
    ids = [d for d, _ in docs if d in positions]
    src = dict(docs)
    cols = []
    for s in spec:
        field, order, missing = s[0], s[1], s[2] if len(s) > 2 else "_last"
        vals = [scores[d] if field == "_score" else _first(
            src[d].get(field)) for d in ids]
        rank = np.array([1 if v is not None else
                         (0 if missing == "_first" else 2) for v in vals])
        # a value's place among the distinct values, exact for any type
        uniq = {v: i for i, v in enumerate(sorted(
            {v for v in vals if v is not None}))}
        key = np.array([uniq.get(v, 0) for v in vals], np.int64)
        cols += [rank, -key if order == "desc" else key]
    pos = np.array([positions[d] for d in ids])
    keys = [pos[:, 2], pos[:, 1], pos[:, 0]] + cols[::-1]
    return [ids[i] for i in np.lexsort(keys)]


def _spec_body(spec):
    return [{f: {"order": o, "missing": m[0]} if m else o}
            for f, o, *m in spec]


WALKS = {
    "long_asc": [("n", "asc"), ("seq", "asc")],
    "keyword_then_long": [("tag", "desc"), ("n", "asc"), ("seq", "desc")],
    "double_missing_first": [("price", "asc", "_first"), ("qty", "desc"),
                             ("seq", "asc")],
    "multi_valued_then_date": [("labels", "desc", "_first"), ("ts", "asc"),
                               ("seq", "asc")],
}


@pytest.mark.parametrize("route", ["mesh", "host"])
@pytest.mark.parametrize("name", sorted(WALKS))
def test_sorted_pages_equal_the_oracle(nodes, name, route, monkeypatch):
    """The first 60 hits of a sort over the whole index, every key type,
    missing first and last: the oracle's order exactly."""
    _ref_node, port = nodes
    spec = WALKS[name]
    want = oracle(_corpus(), _positions(port, "s"), spec)
    got = _port(port, "s", {"sort": _spec_body(spec), "size": 60},
                monkeypatch, mesh=route == "mesh")
    assert _ids(got) == want[:60]


@pytest.mark.parametrize("name", sorted(WALKS))
def test_search_after_walks_the_whole_index(nodes, name, monkeypatch):
    """search_after pages of 23 through all 300 docs: never a doc twice,
    never one skipped, in the oracle's order."""
    _ref_node, port = nodes
    spec = WALKS[name]
    want = oracle(_corpus(), _positions(port, "s"), spec)
    body = {"sort": _spec_body(spec), "size": 23}
    got, after = [], None
    for _ in range(20):
        b = dict(body, search_after=after) if after is not None else body
        page = _port(port, "s", b, monkeypatch, mesh=False)
        assert page["hits"]["total"] == N_DOCS
        if not page["hits"]["hits"]:
            break
        got += _ids(page)
        after = page["hits"]["hits"][-1]["sort"]
    assert got == want


# -- the reference's three faults --------------------------------------------

P_MAPPING = {"properties": {"p": {"type": "long"}, "k": {"type": "keyword"}}}


@pytest.fixture(scope="module")
def small():
    """Four docs, the third without ``p`` nor ``k``; one shard."""
    from elasticsearch_tpu.parallel import aot

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(aot, "_ENABLED", False)
        ref = RefNode(name="ref_small")
        port = Node(name="port_small", device="cpu")
        docs = [("a", {"p": 5, "k": "x"}), ("b", {"p": 3, "k": "y"}),
                ("c", {}), ("d", {"p": 9, "k": "w"})]
        _load([_RefIndexer(ref), port], "p", P_MAPPING, docs, shards=1,
              refreshes=1)
    yield ref, port, docs
    ref.close()
    port.close()


@pytest.mark.parametrize("route", ["mesh", "host"])
@pytest.mark.parametrize("sort", [
    [{"p": "asc"}], [{"p": {"order": "desc", "missing": "_first"}}]])
def test_fault1_docs_missing_the_primary_key_are_returned(small, sort,
                                                          route,
                                                          monkeypatch):
    ref, port, docs = small
    body = {"sort": sort}
    mesh = route == "mesh"
    r = _ref(ref, "p", body, monkeypatch, mesh)
    # the reference counts the doc without `p` but never returns it
    assert r["hits"]["total"] == 4 and len(r["hits"]["hits"]) == 3
    assert "c" not in _ids(r)
    p = _port(port, "p", body, monkeypatch, mesh)
    spec = [(f, c if isinstance(c, str) else c["order"],
             *([] if isinstance(c, str) else [c["missing"]]))
            for s in sort for f, c in s.items()]
    assert p["hits"]["total"] == 4
    assert _ids(p) == oracle(docs, _positions(port, "p"), spec)
    assert next(h["sort"] for h in p["hits"]["hits"]
                if h["_id"] == "c") == [None]


def test_fault1_keyword_primary_routes_disagree_in_the_reference(
        small, monkeypatch):
    ref, port, docs = small
    body = {"sort": ["k"]}
    host = _ref(ref, "p", body, monkeypatch, False)
    mesh = _ref(ref, "p", body, monkeypatch, True)
    assert _ids(host)[-1] == "c" and "c" not in _ids(mesh)
    want = oracle(docs, _positions(port, "p"), [("k", "asc")])
    for route in (True, False):
        got = _port(port, "p", body, monkeypatch, route)
        assert _ids(got) == want and got["hits"]["hits"][-1]["sort"] == [None]
    assert _json(_port(port, "p", body, monkeypatch, False)) == _json(host)


@pytest.mark.parametrize("route", ["mesh", "host"])
def test_custom_missing_value_sorts_last(small, route, monkeypatch):
    """``missing: 0`` sorts the doc without ``p`` as ``_last`` does (the
    reference's rule; ES 2.0 would sort it as 0, first here)."""
    _ref, port, docs = small
    mesh = route == "mesh"
    got = _port(port, "p", {"sort": [{"p": {"order": "asc",
                                            "missing": 0}}]},
                monkeypatch, mesh)
    assert _ids(got) == ["b", "a", "d", "c"]
    assert _json(got) == _json(_port(port, "p", {"sort": [{"p": {
        "order": "asc", "missing": "_last"}}]}, monkeypatch, mesh))


@pytest.fixture(scope="module")
def ties():
    """300 docs tied on ``k``; ``p`` = 1000 - i, so the doc ids ascend
    as ``p`` descends; one shard, one segment."""
    from elasticsearch_tpu.parallel import aot

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(aot, "_ENABLED", False)
        ref = RefNode(name="ref_ties")
        port = Node(name="port_ties", device="cpu")
        docs = [(str(i), {"k": "a", "p": 1000 - i}) for i in range(300)]
        _load([_RefIndexer(ref), port], "t", P_MAPPING, docs, shards=1,
              refreshes=1)
    yield ref, port, docs
    ref.close()
    port.close()


@pytest.mark.parametrize("route", ["mesh", "host"])
def test_fault2_ties_on_the_primary_key_reach_the_secondary(ties, route,
                                                            monkeypatch):
    ref, port, docs = ties
    body = {"sort": ["k", {"p": "asc"}], "size": 3}
    mesh = route == "mesh"
    # the reference's pool holds the 128 lowest doc ids of the tie
    assert _ids(_ref(ref, "t", body, monkeypatch, mesh)) == [
        "127", "126", "125"]
    got = _port(port, "t", body, monkeypatch, mesh)
    want = oracle(docs, _positions(port, "t"), [("k", "asc"), ("p", "asc")])
    assert _ids(got) == want[:3] == ["299", "298", "297"]
    assert [h["sort"] for h in got["hits"]["hits"]] == [
        ["a", 701], ["a", 702], ["a", 703]]


def test_fault3_search_after_on_a_keyword_primary_pages_to_the_end(
        ties, monkeypatch):
    """The reference's pool is the first max(4k, 128) docs by key, with
    no prefilter on a keyword cursor: its pages past the pool come back
    empty. The port's walk covers all 300 docs in the oracle's order."""
    ref, port, docs = ties
    body = {"sort": ["k", {"p": "desc"}], "size": 50}

    def walk(search):
        got, after = [], None
        for _ in range(10):
            b = dict(body, search_after=after) if after else body
            page = search(b)
            if not page["hits"]["hits"]:
                break
            got += _ids(page)
            after = page["hits"]["hits"][-1]["sort"]
        return got

    ref_walk = walk(lambda b: _ref(ref, "t", b, monkeypatch, False))
    assert len(ref_walk) == 200
    want = oracle(docs, _positions(port, "t"), [("k", "asc"), ("p", "desc")])
    assert walk(lambda b: _port(port, "t", b, monkeypatch, False)) == want
    assert ref_walk == want[:200]


@pytest.mark.parametrize("cursor", [["a", "702"], ["a", 702], ["a", 702.0],
                                    ["a", "702.0"]])
def test_string_cursor_on_a_numeric_key_parses(ties, cursor, monkeypatch):
    """A cursor value on a long key is a number, given as one or as a
    string (the reference compares the string with ``str(value)``)."""
    _ref, port, _docs = ties
    got = _port(port, "t", {"sort": ["k", {"p": "asc"}], "size": 2,
                            "search_after": cursor}, monkeypatch, False)
    assert _ids(got) == ["297", "296"]


# -- key space, cursors and parse errors --------------------------------------

EXTREME = [(str(i), {"p": v, "k": f"k{i}"}) for i, v in enumerate(
    [2 ** 63 - 1, -2 ** 63, 0, 2 ** 63 - 2, None, -2 ** 63 + 1, 7, None])]


@pytest.mark.parametrize("missing", ["_first", "_last"])
@pytest.mark.parametrize("order", ["asc", "desc"])
def test_extreme_longs_take_the_rank_lane(order, missing):
    """Longs at the ends of the int64 range leave no room for the
    missing sentinels: the key becomes a rank lane and a value lane,
    still exact, with search_after walking it one doc a page."""
    port = Node(name="ext", device="cpu")
    try:
        docs = [(i, {k: v for k, v in s.items() if v is not None})
                for i, s in EXTREME]
        _load([port], "e", P_MAPPING, docs, shards=1, refreshes=1)
        seg = port.get_index("e").shards[0].segments[0]
        m = seg.sort_keys("p")
        assert not scoring.lanes_safe(m.lo, m.hi, order == "desc")
        spec = [("p", order, missing), ("k", "asc")]
        want = oracle(docs, _positions(port, "e"), spec)
        body = {"sort": _spec_body(spec), "size": 1}
        got, after = [], None
        for _ in range(len(docs) + 1):
            b = dict(body, search_after=after) if got else body
            page = port.search("e", b)
            if not page["hits"]["hits"]:
                break
            got += _ids(page)
            after = page["hits"]["hits"][-1]["sort"]
        assert got == want
    finally:
        port.close()


def _lane_tuple_after(values, cursor, kind, desc, first, terms=None):
    """The port's after-mask for one key over host values, through the
    same lanes the search builds."""
    import torch

    exists = torch.tensor([v is not None for v in values])
    if kind == "rank":
        key = [terms.index(v) if v is not None else 0 for v in values]
        lo, hi = 0, len(terms) - 1
    elif kind == "f64":
        key = scoring.f64_order_keys(
            [v if v is not None else 0.0 for v in values]).tolist()
        present = [k for k, v in zip(key, values) if v is not None]
        lo, hi = min(present), max(present)
    else:
        key = [v if v is not None else 0 for v in values]
        present = [v for v in values if v is not None]
        lo, hi = min(present), max(present)
    safe = scoring.lanes_safe(lo, hi, desc)
    lanes = scoring.sort_lanes(torch.tensor(key, dtype=torch.int64), exists,
                               desc, first, safe)
    cur = scoring.lane_cursor(cursor, kind, desc, first, safe, terms)
    return scoring.after_mask(lanes, cur).tolist()


@pytest.mark.parametrize("kind", ["int", "f64", "rank"])
def test_after_mask_equals_the_reference_cursor(kind):
    """``after_mask`` with ``lane_cursor`` against the reference's
    ``_after_cursor`` on host values: random values with ties and
    missing ones, cursors at, between and beyond them."""
    rng = np.random.default_rng(1)
    terms = sorted({f"t{i:02d}" for i in range(0, 40, 3)})
    for trial in range(40):
        if kind == "int":
            values = [int(x) for x in rng.integers(-5, 6, 30)]
            cursors = [int(x) for x in rng.integers(-7, 8, 4)] + [2.5, -9.5]
        elif kind == "f64":
            values = [float(x) for x in np.round(rng.normal(0, 2, 30), 1)]
            values[0] = -0.0
            cursors = values[:3] + [0.0, 0.05, -100.0, 1e300]
        else:
            values = [terms[i] for i in rng.integers(0, len(terms), 30)]
            cursors = values[:3] + ["t00", "t05", "a", "zz"]
        for i in rng.choice(30, 5, replace=False):
            values[i] = None
        cursors.append(None)
        for c in cursors:
            for desc in (False, True):
                for first in (False, True):
                    spec = [{"field": "f", "order": "desc" if desc else
                             "asc", "missing": "_first" if first
                             else "_last"}]
                    want = [ref_after_cursor((v,), [c], spec)
                            for v in values]
                    got = _lane_tuple_after(values, c, kind, desc, first,
                                            terms)
                    assert got == want, (trial, c, desc, first)


def test_sort_mirror_is_built_and_charged_once(nodes, monkeypatch):
    _ref_node, port = nodes
    br = port.breakers.breaker("fielddata")
    body = {"sort": [{"qty": "asc"}, {"addr": "desc"}], "size": 5}
    _port(port, "s", body, monkeypatch, mesh=False)
    _port(port, "s", body, monkeypatch, mesh=True)  # the round's memo
    used = br.used
    segs = [s for sh in port.get_index("s").shards for s in sh.segments]
    assert all(s._sort_keys["qty"] is s.sort_keys("qty") for s in segs)
    for mesh in (False, True, False):
        _port(port, "s", body, monkeypatch, mesh=mesh)
    assert br.used == used


@pytest.mark.parametrize("body, text", [
    ({"search_after": [1]}, "Sort must contain at least one field"),
    ({"sort": ["n", "tag"], "search_after": [1]},
     "search_after has 1 value(s) but sort has 2"),
    ({"sort": ["n"], "rescore": {"window_size": 5, "query": {
        "rescore_query": QUERY}}}, "cannot use [rescore] in combination"),
    ({"scroll": "1m", "rescore": {"window_size": 5, "query": {
        "rescore_query": QUERY}}}, "[rescore] in combination with [scroll]"),
    ({"sort": ["n"], "search_after": [1, 2]},
     "search_after has 2 value(s) but sort has 1"),
    ({"sort": ["n"], "search_after": ["abc"]}, "does not parse as a number"),
    ({"timeout": "10minutes"}, "failed to parse timeout value"),
])
def test_parse_errors(nodes, body, text):
    _ref_node, port = nodes
    with pytest.raises(SearchParseException) as e:
        port.search("s", body)
    assert text in str(e.value)


def test_msearch_runs_sorted_items_alone(nodes):
    _ref_node, port = nodes
    sorted_body = {"sort": [{"ts": "desc"}], "size": 4}
    plain = {"query": QUERY, "size": 3}
    out = port.msearch([({"index": "s"}, sorted_body),
                        ({"index": "s"}, plain)])["responses"]
    assert _json(out[0]) == _json(port.search("s", sorted_body))
    assert _json(out[1]) == _json(port.search("s", plain))
