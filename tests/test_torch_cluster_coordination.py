"""The cluster's control plane, port against reference.

Each scenario runs on a trio of the JAX package's ``MultiHostCluster``s
and on a trio of the port's (``tests/_torch_cluster.py``), with the same
seeded writes, and the two must agree: who is master (by seat), under
which term, which writes were acknowledged and which refused, with what
typed error. The reference's own chaos scenarios
(``tests/unit/test_coordination_chaos.py``) kill the master with a
probabilistic fault (``prob``/``seed``); here the kill is a
``count=-1`` fault matched on the master's address, armed after a fixed
number of acknowledged writes, which is deterministic in both packages.
"""
import json

import pytest

from _torch_cluster import (EVT_BODY, PACKAGES, Trio, kill, partition,
                            rank_of, seats)
from elasticsearch_tpu.rest.server import RestController as RefController
from elasticsearch_tpu_torch.rest.server import \
    RestController as PortController

CONTROLLER = {"ref": RefController, "port": PortController}


@pytest.fixture(autouse=True)
def _clean_faults():
    for pkg in PACKAGES:
        pkg.faults.clear()
    yield
    for pkg in PACKAGES:
        pkg.faults.clear()


def _trio(pkg, **kw):
    t = Trio(pkg, **kw)
    t[0].data.create_index("evt", EVT_BODY)
    return t


def _both(fn):
    """fn(pkg, trio) on a fresh reference trio and a fresh port trio."""
    out = {}
    for pkg in PACKAGES:
        t = _trio(pkg)
        try:
            out[pkg.name] = fn(pkg, t)
        finally:
            t.close()
    return out["ref"], out["port"]


def _rest(pkg, c, method, path, params=None, body=b""):
    return CONTROLLER[pkg.name](c.node).dispatch(method, path, params or {},
                                                 body)


def test_join_elects_the_bootstrap_master_and_spreads_the_index():
    def run(pkg, t):
        c0, c1, c2 = t.clusters
        meta = c0.dist_indices["evt"]
        return {
            "masters": [c.is_master for c in t.clusters],
            "master_seen": [rank_of(c.node.cluster_state.master_node_id)
                            for c in t.clusters],
            "terms": [c.node.cluster_state.term for c in t.clusters],
            "members": [sorted(rank_of(x) for x in c.node.cluster_state.nodes)
                        for c in t.clusters],
            "quorum": [c.quorum() for c in t.clusters],
            "assignment": seats(meta["assignment"]),
            "in_sync": seats(meta["in_sync"]),
            "primary_terms": meta["primary_terms"],
            # every member holds the same committed metadata
            "same_meta": all(seats(c.dist_indices) == seats(c0.dist_indices)
                             for c in t.clusters),
            "committed_term": [c.committed[0] for c in t.clusters],
        }
    ref, port = _both(run)
    assert port == ref
    assert port["masters"] == [True, False, False]
    assert port["terms"] == [1, 1, 1]
    assert port["quorum"] == [2, 2, 2]
    assert port["same_meta"]


def test_members_report_the_published_state_version():
    """After the joins and a publish, every port member's cluster state
    carries the master's version, as in ES; a reference follower counts
    its own adoptions instead, so its version differs from the master's
    (ROADMAP C25)."""
    versions = {}
    for pkg in PACKAGES:
        t = _trio(pkg)
        try:
            t[1].data.create_index("v2", {"settings": {
                "number_of_shards": 1}})
            versions[pkg.name] = [c.node.cluster_state.version
                                  for c in t.clusters]
        finally:
            t.close()
    port = versions["port"]
    assert port[0] == port[1] == port[2] > 0
    assert len(set(versions["ref"])) > 1


def test_publish_and_commit_reach_every_member():
    """A metadata change (a second index, an alias) is published in two
    phases and applied on every member only at the commit."""
    def run(pkg, t):
        c0, c1, c2 = t.clusters
        before = [c.committed for c in t.clusters]
        c1.data.create_index("second", {"settings": {
            "number_of_shards": 2, "number_of_replicas": 0}})
        t.nodes[2].update_aliases([{"add": {"index": "evt",
                                            "alias": "events"}}])
        after = [c.committed for c in t.clusters]
        return {
            "advanced": [a > b for a, b in zip(after, before)],
            "same_commit": len({a for a in after}) == 1,
            "second": [seats(c.dist_indices.get("second", {})
                             .get("assignment")) for c in t.clusters],
            "alias": [sorted(c.node.indices["evt"].aliases)
                      for c in t.clusters],
            "resolves": [c.data.resolve_index("events") for c in t.clusters],
            "pending": [c._pending_publish for c in t.clusters],
        }
    ref, port = _both(run)
    assert port == ref
    assert all(port["advanced"]) and port["same_commit"]
    assert port["alias"] == [["events"]] * 3
    assert port["pending"] == [None] * 3


def test_publish_commit_fault_leaves_followers_parked():
    """A master that dies between the quorum of acks and the commit
    fan-out (``publish.commit``): the followers hold the parked state and
    never apply it; the master's own copy committed."""
    def run(pkg, t):
        c0, c1, c2 = t.clusters
        pkg.faults.inject("publish.commit", error=OSError, count=1)
        c0.data.create_index("late", {"settings": {"number_of_shards": 1}})
        return {"master_has": "late" in c0.dist_indices,
                "followers_have": ["late" in c.dist_indices
                                   for c in (c1, c2)],
                "parked": [c._pending_publish is not None
                           for c in (c1, c2)]}
    ref, port = _both(run)
    assert port == ref
    assert port == {"master_has": True, "followers_have": [False, False],
                    "parked": [True, True]}


def test_graceful_leave_drops_the_member_and_promotes():
    def run(pkg, t):
        c0, c1, c2 = t.clusters
        for i in range(12):
            t[i % 3].data.index_doc("evt", f"g{i}", {"n": i})
        c0.data.refresh("evt")
        left = c2.local.node_id
        c2.close()
        t.clusters.remove(c2)
        t.nodes[2].close()
        t.nodes.remove(t.nodes[2])
        meta = c0.dist_indices["evt"]
        found = [c1.data.get_doc("evt", f"g{i}")["found"]
                 for i in range(12)]
        return {"members": sorted(rank_of(x)
                                  for x in c0.node.cluster_state.nodes),
                "left_owns": any(left in o
                                 for o in meta["assignment"].values()),
                "assignment": seats(meta["assignment"]),
                "primary_terms": meta["primary_terms"],
                "found": found,
                "c1_sees": sorted(rank_of(x)
                                  for x in c1.node.cluster_state.nodes)}
    ref, port = _both(run)
    assert port == ref
    assert port["members"] == ["0000", "0001"]
    assert not port["left_owns"] and all(port["found"])


def _kill_master_mid_bulk(pkg, t, n_docs=40, kill_at=10):
    c0, c1, c2 = t.clusters
    old_term = c1.node.cluster_state.term
    old_terms = {k: int(v) for k, v
                 in c0.dist_indices["evt"]["primary_terms"].items()}
    acked, refused = [], []
    for i in range(n_docs):
        if i == kill_at:
            kill(pkg, c0)
        try:
            res = c1.data.index_doc("evt", f"d{i}", {"n": i})
            assert res.get("_seq_no") is not None
            acked.append(f"d{i}")
        except Exception as e:
            refused.append((f"d{i}", getattr(e, "error_type", "?")))
    rounds = 0
    while not c1.is_master and rounds < 5 * c1._ping_retries:
        c1.run_fd_round()
        c2.run_fd_round()
        rounds += 1
    meta = c1.dist_indices["evt"]
    for c in (c1, c2):
        c.node.indices["evt"].refresh()
    lost = [d for d in acked if not c1.data.get_doc("evt", d)["found"]]
    after = c1.data.index_doc("evt", "after", {"n": 1000})
    # a zombie write through the old master, on a shard whose primary
    # moved under a bumped term: c0 never ran a detection round and still
    # believes it is master and primary
    zombie_sid = next(int(s) for s, term in meta["primary_terms"].items()
                      if int(term) > old_terms[s])
    zombie_id = next(f"z{k}" for k in range(1000)
                     if pkg.routing.shard_id_for(f"z{k}", 3) == zombie_sid)
    try:
        c0.data.index_doc("evt", zombie_id, {"n": -1})
        zombie = None
    except Exception as e:
        zombie = (getattr(e, "error_type", "?"), getattr(e, "status", 0))
    status, h = _rest(pkg, c1, "GET", "/_cluster/health")
    return {
        "rounds": rounds,
        "master": [rank_of(c.node.cluster_state.master_node_id or "-")
                   for c in (c1, c2)],
        "term": [c.node.cluster_state.term for c in (c1, c2)],
        "old_term": old_term,
        "acked": acked, "refused": refused, "lost": lost,
        "after_acked": after.get("_seq_no") is not None,
        "dead_owns": any(c0.local.node_id in o
                         for o in meta["assignment"].values()),
        "assignment": seats(meta["assignment"]),
        "primary_terms": meta["primary_terms"],
        "zombie": zombie,
        "zombie_landed": c1.node.indices["evt"].shards[zombie_sid]
        .engine.exists(zombie_id),
        "health": (status, h["term"], h["no_master_block"],
                   rank_of(h["master_node"])),
        "won": c1.node.metrics.counter_values().get(
            'estpu_discovery_elections_total{outcome="won"}', 0),
    }


def test_master_killed_mid_bulk_loses_no_acknowledged_write():
    ref, port = _both(_kill_master_mid_bulk)
    assert port == ref
    assert port["master"] == ["0001", "0001"]
    assert port["term"] == [port["old_term"] + 1] * 2
    assert port["acked"] and port["lost"] == []
    assert port["after_acked"] and not port["dead_owns"]
    # the zombie is fenced by the promoted copy: a typed 409
    assert port["zombie"] == ("stale_primary_exception", 409)
    assert not port["zombie_landed"]
    assert port["health"] == (200, port["old_term"] + 1, False, "0001")
    assert port["won"] >= 1


def _partition_and_heal(pkg, t):
    c0, c1, c2 = t.clusters
    for i in range(14):
        c0.data.index_doc("evt", f"p{i}", {"n": i})
    c0.data.refresh("evt")
    committed_before = c0.committed
    partition(pkg, c0, [c1, c2])
    for _ in range(c1._ping_retries):
        c1.run_fd_round()
        c2.run_fd_round()
    for _ in range(c0._ping_retries):
        c0.run_fd_round()
    out = {"majority_master": rank_of(c1.node.cluster_state.master_node_id
                                      or "-"),
           "majority_term": c1.node.cluster_state.term,
           "minority_master": c0.node.cluster_state.master_node_id,
           "stepdowns": c0.node.metrics.counter_values().get(
               "estpu_discovery_master_stepdowns_total", 0)}
    try:
        c0.data.index_doc("evt", "minority", {"n": -1})
        out["minority_write"] = None
    except Exception as e:
        out["minority_write"] = (type(e).__name__, e.status, e.error_type)
    st, body = _rest(pkg, c0, "PUT", "/evt/_doc/minority", {},
                     json.dumps({"n": -1}).encode())
    out["minority_rest"] = (st, body["error"]["type"])
    out["minority_create"] = _rest(pkg, c0, "PUT", "/minorix", {}, b"{}")[0]
    st, body = _rest(pkg, c0, "GET", "/evt/_search", {"size": "0"})
    out["minority_search"] = st
    st, h = _rest(pkg, c0, "GET", "/_cluster/health")
    out["minority_health"] = (h["status"], h["no_master_block"],
                              h.get("cluster_blocks"))
    out["minority_committed_nothing"] = c0.committed == committed_before
    out["majority_write"] = c1.data.index_doc(
        "evt", "majority", {"n": 7}).get("_seq_no") is not None
    c1.data.refresh("evt")
    st, body = _rest(pkg, c1, "GET", "/evt/_search", {"size": "0"})
    out["majority_search"] = (st, body["_shards"]["failed"],
                              body["hits"]["total"])
    pkg.faults.clear()
    for c in t.clusters:
        c.transport.breaker = pkg.transport.PeerBreaker()
    c0.run_fd_round()  # the headless round is the rejoin scan
    out["healed_master"] = rank_of(c0.node.cluster_state.master_node_id
                                   or "-")
    out["healed_term"] = c0.node.cluster_state.term
    out["healed_write"] = c0.data.index_doc(
        "evt", "healed", {"n": 8}).get("_seq_no") is not None
    st, h = _rest(pkg, c0, "GET", "/_cluster/health")
    out["healed_health"] = (st, h["no_master_block"], h["term"])
    return out


def test_partition_minority_answers_writes_with_a_typed_503():
    ref, port = _both(_partition_and_heal)
    assert port == ref
    assert port["majority_master"] == "0001" and port["majority_term"] == 2
    assert port["minority_master"] is None and port["stepdowns"] >= 1
    assert port["minority_write"] == ("ClusterBlockException", 503,
                                      "cluster_block_exception")
    assert port["minority_rest"] == (503, "cluster_block_exception")
    assert port["minority_create"] == 503
    assert port["minority_search"] == 200
    assert port["minority_health"][:2] == ("red", True)
    assert port["minority_committed_nothing"]
    assert port["majority_search"] == (200, 0, 15)
    assert port["healed_master"] == "0001" and port["healed_term"] == 2
    assert port["healed_write"]
    assert port["healed_health"] == (200, False, 2)


def _stale_master(pkg, t):
    c0, c1, c2 = t.clusters
    partition(pkg, c0, [c1, c2])
    for _ in range(c1._ping_retries):  # only the majority notices
        c1.run_fd_round()
        c2.run_fd_round()
    majority_committed = c1.committed
    pkg.faults.clear()
    for c in t.clusters:
        c.transport.breaker = pkg.transport.PeerBreaker()
    out = {"still_thinks": (c0.is_master, c0.node.cluster_state.term)}
    try:
        c0.data.create_index("minor", {"settings": {"number_of_shards": 1}})
        out["create"] = None
    except Exception as e:
        out["create"] = (getattr(e, "error_type", "?"),
                         getattr(e, "status", 0))
    out["after"] = (c0.is_master, "minor" in c0.dist_indices,
                    "minor" in c1.dist_indices,
                    c1.committed >= majority_committed, c1.is_master)
    c0.run_fd_round()
    out["rejoined"] = (rank_of(c0.node.cluster_state.master_node_id or "-"),
                       c0.node.cluster_state.term, c0.committed[0])
    return out


def test_healed_stale_master_steps_down():
    ref, port = _both(_stale_master)
    assert port == ref
    assert port["still_thinks"] == (True, 1)
    assert port["create"][1] in (409, 503)
    assert port["after"] == (False, False, False, True, True)
    assert port["rejoined"] == ("0001", 2, 2)


def test_a_refused_ballot_keeps_the_survivors_headless():
    """``discovery.vote``: with the one other survivor's ballot refused
    the candidate cannot reach a quorum of two; both packages stay
    headless, then win once the fault is spent."""
    def run(pkg, t):
        c0, c1, c2 = t.clusters
        kill(pkg, c0)
        pkg.faults.inject("discovery.vote", error=OSError, count=1)
        for _ in range(c1._ping_retries):
            c1.run_fd_round()
            c2.run_fd_round()
        first = (c1.node.cluster_state.master_node_id,
                 c2.node.cluster_state.master_node_id)
        rounds = 0
        while not c1.is_master and rounds < 3 * c1._ping_retries:
            c1.run_fd_round()
            c2.run_fd_round()
            rounds += 1
        return {"first": first, "then": c1.is_master,
                "term": c1.node.cluster_state.term, "rounds": rounds}
    ref, port = _both(run)
    assert port == ref
    assert port["first"] == (None, None)
    assert port["then"] and port["term"] >= 2
