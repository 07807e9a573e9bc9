"""The REST routes of a cluster member, port against reference.

A reference trio and a port trio (``tests/_torch_cluster.py``) each
serve HTTP from one member that is not the master; the same requests go
to both (``tests/_torch_rest.py``'s ``http``). The member ids and the
transport ports are random in each process, so both answers are first
rewritten with each member's seat (``0000``, ``0001``, ``0002``) in
place of its id and ``<addr>`` in place of its address; then what the
REST harness compares exactly compares exactly here, and scores at the
path's bar.
"""
import json

import pytest

from _torch_cluster import EVT_BODY, PACKAGES, Trio, docs
from _torch_rest import SCORE_RTOL, http, same
from elasticsearch_tpu.rest.server import RestServer as RefServer
from elasticsearch_tpu_torch.rest.server import RestServer as PortServer

SERVERS = {"ref": RefServer, "port": PortServer}


@pytest.fixture(scope="module")
def world():
    from elasticsearch_tpu.parallel import aot

    saved = aot._ENABLED
    aot._ENABLED = False  # its key holds no device layout (ROADMAP C26)
    out = {}
    rows = docs(90, seed=11)
    for pkg in PACKAGES:
        t = Trio(pkg)
        t[0].data.create_index("evt", EVT_BODY)
        for i, (doc_id, src) in enumerate(rows):
            t[i % 3].data.index_doc("evt", doc_id, src)
        t[0].data.refresh("evt")
        srv = SERVERS[pkg.name](t.nodes[1], host="127.0.0.1", port=0)
        srv.start(background=True)
        out[pkg.name] = (t, srv)
    yield out
    for t, srv in out.values():
        srv.stop()
        t.close()
    aot._ENABLED = saved


def _norm(obj, t):
    """Each member's id by its seat, each member's transport address
    by ``<addr>``."""
    subs = []
    for c in t.clusters:
        subs.append((c.local.node_id, c.local.node_id[:4]))
        subs.append((c.local.transport_address, "<addr>"))
    text = json.dumps(obj)
    for a, b in subs:
        text = text.replace(a, b)
    return json.loads(text)


def _both(world, method, path, body=None, ndjson=None):
    out = {}
    for name, (t, srv) in world.items():
        st, payload = http(srv.port, method, path, body, ndjson)
        out[name] = (st, _norm(payload, t))
    return out["ref"], out["port"]


def _same(world, method, path, body=None, ignore=(), scores="generic"):
    (rs, rb), (ps, pb) = _both(world, method, path, body)
    assert ps == rs, (path, rs, rb, ps, pb)
    same(rb, pb, rtol=SCORE_RTOL[scores], ignore=ignore, where=path)
    return rb, pb


def test_cluster_health_reads_the_elected_master_and_term(world):
    rb, pb = _same(world, "GET", "/_cluster/health")
    assert pb["number_of_nodes"] == 3 and pb["term"] == 1
    assert pb["no_master_block"] is False
    # the master id is masked by the harness: compare its seat
    assert _both(world, "GET", "/_cluster/health")[1][1]["master_node"] \
        == "0000"


def test_cluster_state_carries_members_term_and_blocks(world):
    for metric in ("nodes", "blocks", "master_node,version"):
        _same(world, "GET", f"/_cluster/state/{metric}",
              ignore=("version",))
    (_, rb), (_, pb) = _both(world, "GET", "/_cluster/state")
    assert sorted(pb["nodes"]) == sorted(rb["nodes"]) == \
        ["0000", "0001", "0002"]
    assert pb["term"] == rb["term"] == 1


def test_nodes_merges_every_member(world):
    (rs, rb), (ps, pb) = _both(world, "GET", "/_nodes")
    assert rs == ps == 200
    assert sorted(pb["nodes"]) == sorted(rb["nodes"]) == \
        ["0000", "0001", "0002"]
    for seat in pb["nodes"]:
        assert pb["nodes"][seat]["name"] == rb["nodes"][seat]["name"]
        assert pb["nodes"][seat]["transport"] == \
            rb["nodes"][seat]["transport"]
        # every member serves its own index copy's documents
        assert pb["nodes"][seat]["indices"]["docs"] == \
            rb["nodes"][seat]["indices"]["docs"]


def test_cat_nodes_and_cat_master(world):
    _same(world, "GET", "/_cat/nodes?format=json")
    rb, pb = _same(world, "GET", "/_cat/master?format=json")
    assert len(pb) == 1


def test_cat_shards_rows_come_from_the_published_assignment(world):
    rb, pb = _same(world, "GET", "/_cat/shards?format=json",
                   ignore=("store",))
    assert len(pb) == 6
    assert sorted(r["prirep"] for r in pb) == ["p"] * 3 + ["r"] * 3
    assert sum(int(r["docs"]) for r in pb if r["prirep"] == "p") == 90


@pytest.fixture
def ref_breaker_trips_from_zero():
    """The reference's breakers are process-wide (ROADMAP C20): their
    trip counts hold every trip of the process, so what its
    ``_cluster/stats`` reports depends on which tests of the same worker
    ran before (ROADMAP C28). They start from zero here, as the port's
    node-owned breakers do, and are put back after."""
    from elasticsearch_tpu import resources

    brs = resources.BREAKERS
    saved = (brs.parent_tripped,
             {n: b.trip_count for n, b in brs._children.items()})
    brs.parent_tripped = 0
    for b in brs._children.values():
        b.trip_count = 0
    yield
    brs.parent_tripped = saved[0]
    for n, b in brs._children.items():
        b.trip_count = saved[1][n]


def test_cluster_stats_merges_three_parts(world, ref_breaker_trips_from_zero):
    rb, pb = _same(world, "GET", "/_cluster/stats",
                   ignore=("jit", "versions", "store", "segments",
                           "fielddata", "thread_pool", "mem", "docs"))
    assert pb["nodes"]["count"]["total"] == 3
    assert pb["indices"]["count"] == 1
    assert "_nodes" not in pb
    # ROADMAP C23: the port counts a distributed index's docs once, on
    # the primary's owner; the reference counts every copy it holds
    assert pb["indices"]["docs"]["count"] == 90
    assert rb["indices"]["docs"]["count"] == 180


def test_cluster_stats_reports_a_dead_member(world):
    """A member that does not answer counts in ``_nodes.failed``; the
    answer stays 200 (the merge of two parts)."""
    t, srv = world["port"]
    from _torch_cluster import PORT, addr

    a = addr(t[2])
    PORT.faults.inject("transport.send", error=ConnectionRefusedError,
                       count=-1, match=lambda ctx: ctx.get("address") == a)
    try:
        st, body = http(srv.port, "GET", "/_cluster/stats")
    finally:
        PORT.faults.clear()
        for c in t.clusters:
            c.transport.breaker = PORT.transport.PeerBreaker()
    assert st == 200
    assert body["_nodes"] == {"total": 3, "successful": 2, "failed": 1}
    assert body["nodes"]["count"]["total"] == 2


def test_document_routes_go_to_the_owner(world):
    """A write, a get, an update and a delete through the member serving
    HTTP, for docs whose primary lives elsewhere, and a doc route
    (``_explain``) proxied to the owner's own handler."""
    _same(world, "PUT", "/evt/_doc/new1?refresh=true",
          {"n": 5, "body": "alpha echo", "tag": "t1"})
    _same(world, "GET", "/evt/_doc/new1")
    _same(world, "POST", "/evt/_update/new1", {"doc": {"n": 6}})
    _same(world, "GET", "/evt/_doc/d7")
    rb, pb = _same(world, "POST", "/evt/_doc/d7/_explain",
                   {"query": {"match": {"body": "alpha"}}})
    _same(world, "DELETE", "/evt/_doc/new1?refresh=true")
    _same(world, "GET", "/evt/_doc/new1")


def test_search_and_count_scatter_over_the_members(world):
    for body in ({"query": {"match": {"body": "bravo delta"}}, "size": 8},
                 {"size": 0, "aggs": {"t": {"terms": {"field": "tag"}}}}):
        rb, pb = _same(world, "POST", "/evt/_search", body)
        assert pb["_shards"] == {"total": 3, "successful": 3, "failed": 0}
    rb, pb = _same(world, "POST", "/evt/_count",
                   {"query": {"match": {"body": "alpha"}}})
    assert pb["count"] > 0


def test_bulk_refresh_reaches_every_member(world):
    """``_bulk?refresh=true`` on a distributed index: the port refreshes
    every member's copies, so each acknowledged doc is searchable at
    once; the reference refreshes the copies of the member that took the
    request only, and misses the docs the others own (ROADMAP C24)."""
    lines = []
    for i in range(30):
        lines.append(json.dumps({"index": {"_index": "evt",
                                           "_id": f"bulk{i}"}}))
        lines.append(json.dumps({"n": i, "body": "zulu", "tag": "tz"}))
    raw = "\n".join(lines) + "\n"
    counts = {}
    for name, (t, srv) in world.items():
        st, out = http(srv.port, "POST", "/_bulk?refresh=true", ndjson=raw)
        assert st == 200 and not out["errors"]
        st, r = http(srv.port, "POST", "/evt/_count",
                     {"query": {"term": {"tag": "tz"}}})
        counts[name] = r["count"]
    assert counts["port"] == 30
    assert counts["ref"] < 30


def test_tasks_and_pending_tasks_fan_over_the_members(world):
    _same(world, "GET", "/_tasks")
    _same(world, "GET", "/_cluster/pending_tasks")


def test_refused_flight_routes_name_a10g(world):
    """The flight recorder's four routes, refused until A10g was ported,
    answer on a member as the reference's do: the node's rings and
    watchdog, the incident listing, the bundle merging the three
    members' parts, and an unknown incident's typed 404."""
    (rs, rb), (ps, pb) = _both(world, "GET", "/_nodes/_local/flight")
    assert rs == ps == 200
    assert set(pb) == set(rb) == {"flight", "watchdog", "incidents"}
    assert set(pb["flight"]["rings"]) == set(rb["flight"]["rings"])
    assert pb["flight"]["ring_caps"] == rb["flight"]["ring_caps"]
    # the recorder follows the member's cluster id (the reference's
    # keeps the id its node had before joining)
    t, srv = world["port"]
    assert pb["flight"]["node"] == t.nodes[1].node_id[:4]
    # the listing holds what the process persisted (it depends on the
    # tests run before in it): the same status and columns
    (rs, rb), (ps, pb) = _both(world, "GET", "/_cat/incidents?format=json")
    assert rs == ps == 200
    assert all(set(r) == {"id", "detector", "node", "timestamp", "reason"}
               for r in pb + rb)
    (rs, rb), (ps, pb) = _both(world, "GET", "/_cluster/diagnostics")
    assert rs == ps == 200
    assert set(pb) == set(rb)
    assert pb["_nodes"] == rb["_nodes"] == {
        "total": 3, "successful": 3, "failed": 0}
    assert sorted(pb["nodes"]) == sorted(rb["nodes"]) == \
        ["0000", "0001", "0002"]
    for seat, part in pb["nodes"].items():
        assert set(part) == set(rb["nodes"][seat])
        assert part["name"] == rb["nodes"][seat]["name"]
    (rs, rb), (ps, pb) = _both(world, "GET",
                               "/_cluster/diagnostics/incidents/x:1")
    assert rs == ps == 404
    assert pb["error"]["type"] == rb["error"]["type"]
