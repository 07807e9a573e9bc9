"""The cluster's data plane on a replicated 3-shard index over three
members, port against reference and against one port ``Node``.

The same seeded docs go through the three coordinators of a reference
trio and of a port trio (``tests/_torch_cluster.py``); then every body
is answered by each package's cluster and by one port ``Node`` holding
the same 3 shards and docs. What must agree: ids, their order,
``hits.total``, ``_shards``, aggregation buckets, suggestions; scores
at the bar of the path's existing parity test (``_torch_rest.py``'s
``SCORE_RTOL``: a member's query phase takes the host loop, the single
node the mesh, which runs B1's bf16 product on the dense rows).
"""
import threading
import time

import pytest

from _torch_cluster import EVT_BODY, PACKAGES, REF, Trio, docs, seats
from _torch_rest import SCORE_RTOL, same
from elasticsearch_tpu_torch.node import Node as PortNode

N_DOCS = 240


@pytest.fixture(scope="module")
def world():
    from elasticsearch_tpu.parallel import aot

    # the reference's AOT cache keys no device layout: a program traced
    # for one member's shard count serves another's (ROADMAP C26)
    saved = aot._ENABLED
    aot._ENABLED = False
    rows = docs(N_DOCS)
    trios = {}
    for pkg in PACKAGES:
        t = Trio(pkg)
        t[0].data.create_index("evt", EVT_BODY)
        for i, (doc_id, src) in enumerate(rows):
            t[i % 3].data.index_doc("evt", doc_id, src)
        t[0].data.refresh("evt")
        trios[pkg.name] = t
    single = PortNode(name="single", device="cpu")
    single.create_index("evt", {
        "settings": {"number_of_shards": 3, "number_of_replicas": 0},
        "mappings": EVT_BODY["mappings"]})
    for doc_id, src in rows:
        single.index("evt", doc_id, src)
    single.refresh("evt")
    yield trios, single
    single.close()
    for t in trios.values():
        t.close()
    aot._ENABLED = saved


def _ids(r):
    return [h["_id"] for h in r["hits"]["hits"]]


def _same_hits(a, b, rtol):
    assert _ids(a) == _ids(b)
    assert a["hits"]["total"] == b["hits"]["total"]
    for x, y in zip(a["hits"]["hits"], b["hits"]["hits"]):
        if x.get("_score") is not None:
            assert y["_score"] == pytest.approx(x["_score"], rel=rtol)
        assert x["_source"] == y["_source"]
        assert x.get("sort") == y.get("sort")


BODIES = {
    "match": {"query": {"match": {"body": "alpha charlie"}}, "size": 15},
    "match_page": {"query": {"match": {"body": "bravo"}}, "size": 7,
                   "from": 5},
    "bool": {"query": {"bool": {
        "must": [{"match": {"body": "delta"}}],
        "should": [{"match": {"body": "echo golf"}}],
        "filter": [{"range": {"n": {"gte": 100, "lt": 900}}}],
        "must_not": [{"term": {"tag": "t3"}}]}}, "size": 12},
    "aggs": {"size": 3, "query": {"match": {"body": "alpha"}},
             "aggs": {"tags": {"terms": {"field": "tag"},
                               "aggs": {"s": {"sum": {"field": "n"}}}},
                      "avg_n": {"avg": {"field": "n"}},
                      "card": {"cardinality": {"field": "tag"}},
                      "pct": {"percentiles": {"field": "n",
                                              "percents": [25, 50, 99]}},
                      "hist": {"histogram": {"field": "n",
                                             "interval": 250}}}},
    "sort": {"query": {"match": {"body": "bravo"}},
             "sort": [{"n": "desc"}, {"tag": "asc"}], "size": 10},
}


@pytest.mark.parametrize("name", sorted(BODIES))
def test_query_then_fetch_matches_the_reference_and_one_node(world, name):
    trios, single = world
    body = BODIES[name]
    answers = {pkg.name: [trios[pkg.name][i].data.search("evt", dict(body))
                          for i in range(3)] for pkg in PACKAGES}
    port = answers["port"]
    for r in port[1:]:  # every coordinator gives the same answer
        same(port[0], r, rtol=0.0)
    assert port[0]["_shards"] == {"total": 3, "successful": 3, "failed": 0}
    same(answers["ref"][0], port[0], rtol=SCORE_RTOL["generic"])
    one = single.search("evt", dict(body))
    _same_hits(one, port[0], SCORE_RTOL["fused"])
    if "aggs" in body:
        same({"aggregations": one["aggregations"]},
             {"aggregations": port[0]["aggregations"]})


def test_scroll_pages_through_every_hit(world):
    trios, single = world
    body = {"query": {"match": {"body": "alpha"}}, "size": 25,
            "scroll": "1m"}
    pages = {}
    for pkg in PACKAGES:
        from importlib import import_module

        svc = import_module(
            ("elasticsearch_tpu" if pkg is REF else "elasticsearch_tpu_torch")
            + ".search.service")
        r = trios[pkg.name][2].data.search("evt", dict(body))
        got = _ids(r)
        sid = r["_scroll_id"]
        while True:
            nxt = svc.scroll_next(sid)
            if not nxt["hits"]["hits"]:
                break
            got += _ids(nxt)
            sid = nxt.get("_scroll_id", sid)
        pages[pkg.name] = (r["hits"]["total"], got)
    assert pages["port"] == pages["ref"]
    total, got = pages["port"]
    assert len(got) == total == len(set(got))
    one = single.search("evt", {"query": body["query"], "size": 1000})
    assert got == _ids(one)


def test_suggest_fans_over_the_primary_owners(world):
    trios, single = world
    body = {"size": 0, "suggest": {"s": {"text": "alpah bravoo",
                                         "term": {"field": "body"}}}}
    ref = trios["ref"][1].data.search("evt", dict(body))
    port = trios["port"][1].data.search("evt", dict(body))
    assert port["suggest"] == ref["suggest"]
    assert port["suggest"] == single.search("evt", dict(body))["suggest"]


def test_routed_writes_get_update_and_delete(world):
    trios, _single = world
    out = {}
    for pkg in PACKAGES:
        t = trios[pkg.name]
        t[0].data.create_index("w", EVT_BODY)
        log = []
        for i in range(18):
            r = t[i % 3].data.index_doc("w", f"x{i}", {"n": i,
                                                       "body": "echo"})
            log.append((r["_id"], r["_version"], r.get("created")))
        # the doc lives on its owners only: the primary and one replica
        holders = [sum(n.indices["w"].shards[s].engine.exists("x5")
                       for s in range(3)) for n in t.nodes]
        u = t[2].data.update_doc("w", "x5", {"doc": {"n": 500}})
        got = [t[k].data.get_doc("w", "x5") for k in range(3)]
        d = t[1].data.delete_doc("w", "x6")
        gone = t[0].data.get_doc("w", "x6")["found"]
        t[0].data.refresh("w")
        cnt = t[1].data.search("w", {"size": 0})["hits"]["total"]
        # the replica copy saw every write through the fan-out
        meta = t[0].dist_indices["w"]
        sid = pkg.routing.shard_id_for("x5", 3)
        rep = meta["assignment"][str(sid)][1]
        rep_node = next(n for n in t.nodes if n.node_id == rep)
        rep_src = rep_node.indices["w"].shards[sid].engine.get("x5")
        out[pkg.name] = {"log": log, "holders": holders,
                         "update": (u["_version"], u.get("result")),
                         "got": [(g["found"], g["_version"],
                                  g["_source"]["n"]) for g in got],
                         "delete": (d["found"], d["_version"]),
                         "gone": gone, "count": cnt,
                         "replica": rep_src["_source"]["n"],
                         "assignment": seats(meta["assignment"])}
    assert out["port"] == out["ref"]
    assert out["port"]["got"] == [(True, 2, 500)] * 3
    assert out["port"]["count"] == 17 and out["port"]["replica"] == 500


def test_by_query_runs_remote_children_and_cancels(world, monkeypatch):
    """A delete-by-query fans one pass to each primary owner; each
    owner's pass is a child task of the coordinator's (parent carried
    by the wire header), and cancelling the coordinator's task stops the
    remote passes, which report ``canceled`` with partial counts."""
    trios, _single = world
    from elasticsearch_tpu_torch.cluster.search_action import \
        DistributedDataService

    t = trios["port"]
    t[0].data.create_index("bq", EVT_BODY)
    for i in range(60):
        t[i % 3].data.index_doc("bq", f"b{i}", {"n": i, "body": "kilo"})
    t[0].data.refresh("bq")
    ref_t = trios["ref"]
    ref_t[0].data.create_index("bq", EVT_BODY)
    for i in range(60):
        ref_t[i % 3].data.index_doc("bq", f"b{i}", {"n": i, "body": "kilo"})
    ref_t[0].data.refresh("bq")
    # a whole pass, uncancelled: the same counts in both packages
    q = {"query": {"range": {"n": {"lt": 20}}}}
    r_ref = ref_t[1].data.by_query("bq", q, "delete")
    r_port = t[1].data.by_query("bq", q, "delete")
    assert {k: r_port[k] for k in ("total", "deleted", "failures")} == \
        {k: r_ref[k] for k in ("total", "deleted", "failures")} == \
        {"total": 20, "deleted": 20, "failures": []}

    # now a slow one on the port, cancelled mid-way
    started = threading.Event()
    release = threading.Event()
    orig = DistributedDataService._primary_write

    def slow(self, *a, **kw):
        started.set()
        release.wait(0.05)
        return orig(self, *a, **kw)

    monkeypatch.setattr(DistributedDataService, "_primary_write", slow)
    result = {}
    coord = t[0]
    th = threading.Thread(target=lambda: result.setdefault(
        "r", coord.data.by_query("bq", {"query": {"match_all": {}}},
                                 "delete")))
    th.start()
    assert started.wait(10)
    # wait on the remote child's registration, not a poll of timings
    child = None
    deadline = time.monotonic() + 10
    while child is None and time.monotonic() < deadline:
        for c in t.clusters[1:]:
            # (no ``actions`` pattern: fnmatch reads ``[s]`` as a
            # character class)
            for task in c.node.tasks.list_tasks():
                if task.action.endswith("byquery[s]"):
                    child = (c, task)
        time.sleep(0.01)
    assert child is not None, "no remote child task"
    parent = [x for x in coord.node.tasks.list_tasks(
        actions="indices:data/write/delete/byquery")][0]
    assert child[1].parent == (parent.node, parent.id)
    coord.node.tasks.cancel(parent.id)
    res = coord.data.cancel_task_children(parent.node, parent.id)
    th.join(30)
    assert not th.is_alive()
    r = result["r"]
    assert "canceled" in r and r["deleted"] < 40
    assert res.get("node_failures") is None
    for c in t.clusters:
        assert not c.node.tasks.list_tasks(actions="*byquery*")


def test_snapshot_and_restore_across_members(world, tmp_path):
    trios, _single = world
    out = {}
    for pkg in PACKAGES:
        t = trios[pkg.name]
        loc = str(tmp_path / pkg.name)
        snap = t[1].data.create_snapshot(loc, "s1", indices=["evt"])
        r = t[2].data.restore_snapshot(loc, "s1", indices=["evt"],
                                       rename_pattern="evt",
                                       rename_replacement="evt2")
        t[0].data.refresh("evt2")
        hits = t[1].data.search("evt2", {"query": {"match": {
            "body": "alpha"}}, "size": 5})
        meta = t[0].dist_indices["evt2"]
        out[pkg.name] = {
            "snap": (snap["snapshot"]["state"], snap["snapshot"]["shards"]),
            "restore": r["snapshot"]["shards"],
            "total": t[2].data.search("evt2", {"size": 0})["hits"]["total"],
            "ids": _ids(hits),
            "copies": sorted(len(o) for o in meta["assignment"].values()),
        }
    assert out["port"] == out["ref"]
    assert out["port"]["total"] == N_DOCS
    assert out["port"]["restore"] == {"total": 3, "failed": 0,
                                      "successful": 3}


def test_delete_index_cluster_wide(world):
    trios, _single = world
    out = {}
    for pkg in PACKAGES:
        t = trios[pkg.name]
        t[0].data.create_index("gone", {"settings": {
            "number_of_shards": 2, "number_of_replicas": 1}})
        t[1].data.index_doc("gone", "a", {"n": 1})
        # through a member that is not the master, by the Node API
        t.nodes[2].delete_index("gone")
        out[pkg.name] = [("gone" in c.dist_indices,
                          "gone" in c.node.indices) for c in t.clusters]
    assert out["port"] == out["ref"] == [(False, False)] * 3


def test_query_phase_reply_packs_host_values_only(world):
    """Every aggregator's partial and the query phase's reply reach the
    wire as host values: ``pack`` refuses a tensor, so a reply that
    packs is proof."""
    import json

    trios, _single = world
    t = trios["port"]
    res = t[1].data._on_query({"index": "evt", "body": BODIES["aggs"],
                               "shards": [0, 1, 2]})
    json.dumps(res)
    t[1].data._on_free({"context_id": res["context_id"]})
    assert res["aggs"] is not None


def test_profile_merges_every_owners_shards(world):
    """``profile: true``: one entry a shard, each labelled with its
    owner, the remote ones carried back on the query phase's reply."""
    trios, _single = world
    labels = {}
    for pkg in PACKAGES:
        r = trios[pkg.name][0].data.search("evt", {
            "size": 3, "profile": True,
            "query": {"match": {"body": "alpha"}}})
        shards = r["profile"]["shards"]
        labels[pkg.name] = sorted(
            seats(sp["id"].split("]")[0].lstrip("[")) for sp in shards)
        for sp in shards:
            assert "device_execute_nanos" in sp["tpu"]["phases"]
    assert labels["port"] == labels["ref"] == ["0000", "0001", "0002"]
