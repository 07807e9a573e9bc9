"""Index admin, cluster, nodes, ``_cat`` and snapshots over HTTP: the
port's server against the reference's, the same requests to both
(``tests/_torch_rest.py``).

Every answer is held exactly but for the volatile keys the harness masks
(node ids, clocks, uuids, the process, host and device sections). Where
the two sections of a node's stats differ by design (the compile/warm
layer's counts: the programs each package runs are its own), the test
names each section.
"""
import pytest

from _torch_parity import corpus
from _torch_rest import Pair, masked, ndjson, node_ids_out, same

MAPPING = {"properties": {
    "body": {"type": "text", "analyzer": "english"},
    "tag": {"type": "keyword"},
    "n": {"type": "long"},
    "price": {"type": "double"},
}}
DOCS = corpus(60, seed=3)
#: a search (it moves the port's counters)
SEARCH = {"query": {"match": {"body": DOCS[0][1]["body"].split()[0]}}}


@pytest.fixture(scope="module")
def pair():
    p = Pair()
    yield p
    p.close()


@pytest.fixture(scope="module")
def quiet():
    """A pair whose watchdogs tick only when a test drives them
    (``run_once``): their interval is longer than any test runs."""
    p = Pair(watchdog_interval_s=3600.0)
    yield p
    p.close()


def _load(pair):
    pair.wipe()
    pair.same("PUT", "/logs", {"settings": {"index": {
        "number_of_shards": 2, "search": {"mesh": "false"}}},
        "mappings": MAPPING})
    lines = []
    for doc_id, src in DOCS:
        lines += [{"index": {"_index": "logs", "_id": doc_id}}, src]
    pair.same("POST", "/_bulk?refresh=true", ndjson=ndjson(lines))
    return pair


@pytest.fixture
def idx(pair):
    return _load(pair)


@pytest.fixture
def quiet_idx(quiet):
    return _load(quiet)


def test_create_delete_exists(idx):
    s = idx.same
    s("HEAD", "/logs")
    s("HEAD", "/nope")
    s("PUT", "/logs", {})
    s("PUT", "/Bad", {}, ignore=("reason",))
    s("PUT", "/second", {"settings": {"number_of_shards": 1,
                                      "number_of_replicas": 1}})
    s("GET", "/second")
    s("GET", "/logs/_settings")
    s("GET", "/logs,second/_settings?flat_settings=true")
    s("GET", "/_settings")
    s("GET", "/logs/_settings/index.number_*")
    s("DELETE", "/second")
    s("DELETE", "/second")
    s("GET", "/logs/_settings,_mappings")


def test_mappings(idx):
    s = idx.same
    s("GET", "/logs/_mapping")
    s("GET", "/_mapping")
    s("PUT", "/logs/_mapping", {"properties": {"extra": {"type": "long"}}})
    s("PUT", "/logs/_mapping", {"properties": {"n": {"type": "text"}}})
    s("PUT", "/logs/item/_mapping", {"properties": {"sku": {
        "type": "keyword"}}})
    s("GET", "/logs/_mapping/item")
    s("HEAD", "/logs/_mapping/item")
    s("HEAD", "/logs/_mapping/other")
    s("GET", "/logs/_mapping/field/tag,n")
    s("GET", "/_mapping/field/pri*")
    s("GET", "/logs/_mapping/item/field/sku")


def test_settings_open_close(idx):
    s = idx.same
    s("PUT", "/logs/_settings", {"index": {"number_of_replicas": 1}})
    s("GET", "/logs/_settings")
    s("PUT", "/logs/_settings", {"index": {"number_of_shards": 3}})
    s("POST", "/logs/_close")
    s("POST", "/logs/_search", {})
    s("GET", "/_cat/indices?format=json")
    s("POST", "/logs/_open")
    s("POST", "/logs/_count")
    s("PUT", "/logs/_settings", {"index": {"blocks": {"write": True}}})
    s("PUT", "/logs/_doc/w1", {"body": "blocked"})
    s("PUT", "/logs/_settings", {"index": {"blocks": {"write": False}}})
    s("GET", "/_cluster/state/blocks")


def test_aliases_and_templates(idx):
    s = idx.same
    s("POST", "/_aliases", {"actions": [
        {"add": {"index": "logs", "alias": "all_logs"}},
        {"add": {"index": "logs", "alias": "t1_logs",
                 "filter": {"term": {"tag": "t1"}}}}]})
    s("GET", "/_aliases")
    s("GET", "/_alias/t1_*")
    s("HEAD", "/_alias/all_logs")
    s("HEAD", "/_alias/none")
    # ROADMAP C13: the reference stores an alias's filter and applies
    # none; the port applies it, as ES 2.0 does
    (rs, rb), (ps, pb) = idx.both("POST", "/t1_logs/_search",
                                  {"query": {"match_all": {}}, "size": 60})
    assert rs == ps == 200
    assert rb["hits"]["total"] == len(DOCS)
    t1 = sorted(d for d, src in DOCS if src["tag"] == "t1")
    assert sorted(h["_id"] for h in pb["hits"]["hits"]) == t1
    assert pb["hits"]["total"] == len(t1)
    s("PUT", "/logs/_alias/extra", {"routing": "1"})
    s("GET", "/logs/_alias")
    s("DELETE", "/logs/_alias/extra")
    s("DELETE", "/logs/_alias/extra")
    s("PUT", "/_template/tpl", {"template": "te*", "order": 1,
                                "settings": {"number_of_shards": 1},
                                "mappings": {"properties": {
                                    "k": {"type": "keyword"}}}})
    s("GET", "/_template/tpl")
    s("GET", "/_template")
    s("HEAD", "/_template/tpl")
    s("PUT", "/test1/_doc/1", {"k": "v"})
    s("GET", "/test1/_mapping")
    s("GET", "/_cat/templates?format=json")
    s("DELETE", "/_template/tpl")
    s("GET", "/_template/tpl")


def test_warmers_are_stored(idx):
    """Warmer CRUD stores the warmer (neither server runs it)."""
    s = idx.same
    s("PUT", "/logs/_warmer/w1", {"query": {"match_all": {}}})
    s("GET", "/logs/_warmer")
    s("GET", "/logs/_warmer/w*")
    s("GET", "/_warmer/w1")
    s("DELETE", "/logs/_warmer/w1")
    s("DELETE", "/logs/_warmer/w1")


def test_lifecycle_ops(idx):
    s = idx.same
    s("POST", "/logs/_refresh")
    s("POST", "/_bulk?refresh=true", ndjson=ndjson(
        x for i in range(8)
        for x in ({"index": {"_index": "logs", "_id": f"m{i}"}},
                  {"body": "second segment", "tag": "t1"})))
    s("POST", "/_refresh")
    s("POST", "/logs/_flush")
    s("POST", "/logs/_optimize?max_num_segments=1")
    s("POST", "/_forcemerge")
    s("POST", "/logs/_upgrade")
    s("GET", "/logs/_upgrade")
    s("POST", "/logs/_cache/clear")
    s("GET", "/logs/_segments")
    s("GET", "/logs/_recovery")
    # ROADMAP C19: the port's merge stats carry ES 2.0's total_docs,
    # which the reference's shards do not count
    r, p = s("GET", "/logs/_stats", ignore=("total_docs",))
    assert "total_docs" not in r["_all"]["primaries"]["merges"]
    assert p["_all"]["primaries"]["merges"]["total_docs"] == len(DOCS) + 8
    s("GET", "/logs/_stats/docs,indexing")
    s("GET", "/_stats?level=shards", ignore=("total_docs",))


def test_analyze(idx):
    s = idx.same
    s("POST", "/_analyze", {"text": "The Quick Foxes", "analyzer": "english"})
    s("GET", "/_analyze?text=Running+dogs&tokenizer=whitespace"
             "&filters=lowercase")
    s("POST", "/logs/_analyze", {"text": "Running dogs", "field": "body"})
    s("POST", "/_analyze", {"text": "x", "analyzer": "nope"})


def test_cluster(idx):
    s = idx.same
    s("GET", "/_cluster/health")
    s("GET", "/_cluster/health?level=shards")
    s("GET", "/_cluster/state")
    s("GET", "/_cluster/state/metadata,routing_table/logs")
    # nodes.jit counts the reference's jit traces and the port's
    # first-touch events (tracing/retrace.py): the same key, each
    # package's own count
    r, p = s("GET", "/_cluster/stats", ignore=("jit",))
    assert set(p["nodes"]["jit"]) == set(r["nodes"]["jit"]) == {
        "traces_total"}
    assert isinstance(p["nodes"]["jit"]["traces_total"], int)
    s("GET", "/_cluster/settings")
    s("PUT", "/_cluster/settings", {"transient": {
        "indices.breaker.request.limit": "40%",
        "serving.coalescer.mode": "always"}})
    s("GET", "/_cluster/settings")
    s("PUT", "/_cluster/settings", {"transient": {
        "indices.breaker.request.limit": None,
        "serving.coalescer.mode": None}})
    s("GET", "/_cluster/pending_tasks")
    s("POST", "/_cluster/reroute?explain=true", {"commands": [
        {"move": {"index": "logs", "shard": 0, "from_node": "a",
                  "to_node": "b"}}]})
    s("POST", "/_cluster/reroute", {"commands": [{"bogus": {}}]})


def _tick_both(pair):
    """One driven watchdog tick on each server, its counter cursor
    started afresh, so the tick only seeds the cursor and records no
    ``metrics`` event: the packages' counters move on different requests
    (the reference's on its compiles, the port's on every search), so a
    tick after a request records on one side and not the other."""
    for node in (pair.ref, pair.port):
        node.watchdog._last_counters = None
        node.watchdog.run_once()


def test_nodes_info_and_stats(quiet_idx):
    """The two servers' node views: equal where both have a section; the
    reference's own sections named one by one. The watchdogs tick only
    when driven, the same ticks on each side (ROADMAP C38: each server's
    1 s tick thread fed the ``metrics`` ring at its own times)."""
    _tick_both(quiet_idx)
    _hold_node_views(quiet_idx)


def test_node_views_see_an_extra_tick(quiet_idx):
    """The comparison holds the ``metrics`` ring exactly: one more tick on
    one side, after a search moved its counters, fails it."""
    _tick_both(quiet_idx)
    _hold_node_views(quiet_idx)
    quiet_idx.same("POST", "/logs/_search", SEARCH)
    quiet_idx.port.watchdog.run_once()
    with pytest.raises(AssertionError, match="metrics"):
        _hold_node_views(quiet_idx)


def _hold_node_views(idx):
    (rs, rb), (ps, pb) = idx.both("GET", "/_nodes/stats")
    assert rs == ps == 200
    r = next(iter(rb["nodes"].values()))
    p = next(iter(pb["nodes"].values()))
    assert set(r) == set(p)
    # the program registry's totals: the same keys, each package's own
    # programs
    assert set(p["programs"]) == set(r["programs"])
    assert p["transport"] == r["transport"]
    # the flight recorder's rings and the watchdog's state: the same
    # keys and counts, but the compile ring's, fed by each package's own
    # first touches in the process (the port's first dispatches of a
    # key, the reference's jit traces), which tests run before in the
    # process may already have paid
    assert set(p["flight"]) == set(r["flight"]) == {"counts", "retained"}
    for sec in ("counts", "retained"):
        assert set(p["flight"][sec]) == set(r["flight"][sec])
        for ring, n in r["flight"][sec].items():
            if ring != "compiles":
                assert p["flight"][sec][ring] == n, (sec, ring)
    assert set(r["watchdog"]) == set(p["watchdog"])
    assert r["watchdog"]["config"] == p["watchdog"]["config"]
    for k in ("running", "trips", "incidents_captured", "inflight_ops"):
        assert p["watchdog"][k] == r["watchdog"][k], k
    # the reference's breakers are process-wide (their estimates carry
    # every node of the process), the port's belong to the node: the
    # same breakers, limits and overheads
    assert set(r["breakers"]) == set(p["breakers"])
    for name, br in r["breakers"].items():
        assert set(br) == set(p["breakers"][name])
        for k in ("limit_size_in_bytes", "overhead"):
            assert p["breakers"][name][k] == br[k], (name, k)
    for key in ("name", "indices", "thread_pool", "tasks", "slowlog"):
        same(node_ids_out(r[key], idx.ref.node_id),
             node_ids_out(p[key], idx.port.node_id),
             ignore=("kernels", "rehydrations", "events",
                     "mesh_fallback_total", "mesh_host_by_design",
                     "span_clause_truncated", "launches"))
    assert set(p["serving"]) == set(r["serving"]) == {"coalescer", "qos",
                                                      "warmup"}
    same(r["serving"]["qos"], p["serving"]["qos"])
    assert set(p["serving"]["warmup"]) == set(r["serving"]["warmup"])
    (rs, _), (ps, _) = idx.both("GET", "/_nodes")
    assert rs == ps == 200
    (rs, _), (ps, _) = idx.both("GET", "/_nodes/_local/stats/indices")
    assert rs == ps == 200


def test_hot_threads_shape(idx):
    (rs, rb), (ps, pb) = idx.both(
        "GET", "/_nodes/hot_threads?snapshots=2&interval=10ms")
    assert rs == ps == 200
    for text, node in ((rb, idx.ref), (pb, idx.port)):
        lines = text.splitlines()
        assert lines[0] == f"::: {{{node.name}}}{{{node.node_id}}}"
        assert lines[1].startswith("   Hot threads sampling: interval=10ms,"
                                   " snapshots=2, busiestThreads=3,")


@pytest.mark.parametrize("path", [
    "/_cat/indices", "/_cat/indices/logs", "/_cat/health", "/_cat/count",
    "/_cat/count/logs", "/_cat/shards", "/_cat/shards/logs",
    "/_cat/segments", "/_cat/aliases", "/_cat/master", "/_cat/templates",
    "/_cat/recovery", "/_cat/pending_tasks", "/_cat/plugins",
    "/_cat/fielddata", "/_cat/repositories", "/_cat/nodes",
    "/_cat/allocation", "/_cat/thread_pool", "/_cat/tasks", "/_cat"])
def test_cat_text_and_json(idx, path):
    # thread pool rows count this request's own pool work
    for query in ("", "?v", "?format=json", "?help"):
        (rs, rb), (ps, pb) = idx.both("GET", path + query)
        assert rs == ps, (path, query)
        if isinstance(rb, str):
            assert _cat_columns(rb, query) == _cat_columns(pb, query)
        else:
            same(node_ids_out(rb, idx.ref.node_id),
                 node_ids_out(pb, idx.port.node_id))


def _cat_columns(text: str, query: str):
    """A text table's header (``?v``) or row count: the cells carry the
    masked values (clocks, node ids, process numbers)."""
    lines = text.splitlines()
    if query == "?v" and lines:
        return lines[0].split()
    return len(lines)


def test_cat_values(idx):
    """The rows' values where nothing volatile rides them."""
    for path in ("/_cat/indices?format=json&h=index,docs.count,pri,rep",
                 "/_cat/shards?format=json&h=index,shard,prirep,docs",
                 "/_cat/count/logs?format=json&h=count",
                 "/_cat/segments?format=json&h=index,shard,docs.count"):
        idx.same("GET", path)


def test_snapshots(idx, tmp_path):
    s = idx.same
    for side, root in (("ref", tmp_path / "r"), ("port", tmp_path / "p")):
        root.mkdir()
    # each server writes its own repository directory
    for port, root in ((idx.ref_server.port, tmp_path / "r"),
                       (idx.port_server.port, tmp_path / "p")):
        from _torch_rest import http

        st, out = http(port, "PUT", "/_snapshot/backup", {
            "type": "fs", "settings": {"location": str(root)}})
        assert st == 200 and out == {"acknowledged": True}
    (rs, rb), (ps, pb) = idx.both("GET", "/_snapshot/backup")
    assert rs == ps == 200
    assert set(rb["backup"]) == set(pb["backup"])
    s("PUT", "/_snapshot/backup/snap1", {"indices": "logs"})
    s("GET", "/_snapshot/backup/snap1", ignore=("start_time",
                                                "end_time",
                                                "duration_in_millis",
                                                "start_time_in_millis",
                                                "end_time_in_millis"))
    s("GET", "/_snapshot/backup/snap1/_status")
    s("GET", "/_cat/snapshots/backup?format=json&h=id,status,indices")
    s("POST", "/_snapshot/backup/_verify")
    s("DELETE", "/logs")
    s("POST", "/_snapshot/backup/snap1/_restore", {})
    s("POST", "/logs/_count")
    s("POST", "/_snapshot/backup/snap1/_restore", {
        "rename_pattern": "logs", "rename_replacement": "copy"})
    s("POST", "/copy/_search", {"query": {"term": {"tag": "t2"}},
                                "size": 30})
    s("GET", "/_snapshot/backup/nope")
    s("DELETE", "/_snapshot/backup/snap1")
    s("DELETE", "/_snapshot/backup")
    s("GET", "/_snapshot")
