"""The cluster's allocation: deciders, reroute, relocation, promotion,
recovery on join and gateway resurrection, port against reference.

The deciders run on the same inputs in both packages. The cluster
scenarios run on members of each package in this process (two, then a
third and a fourth joining), with the live allocator's background kicks
off (``enabled = False``) so each test drives its moves; both packages
must reach the same placement by seat, serve every acknowledged doc and
count the same moves.
"""
import json
import time

import pytest

from _torch_cluster import PACKAGES, addr, kill, seats
from elasticsearch_tpu.cluster.state import DiscoveryNode as RefDN
from elasticsearch_tpu.cluster.state import ShardRouting as RefSR
from elasticsearch_tpu.rest.server import RestController as RefController
from elasticsearch_tpu_torch.cluster.state import DiscoveryNode as PortDN
from elasticsearch_tpu_torch.cluster.state import ShardRouting as PortSR
from elasticsearch_tpu_torch.rest.server import \
    RestController as PortController

KINDS = {"ref": (RefDN, RefSR, RefController),
         "port": (PortDN, PortSR, PortController)}
INDEX_BODY = {"settings": {"number_of_shards": 4, "number_of_replicas": 1},
              "mappings": {"properties": {"n": {"type": "integer"}}}}


@pytest.fixture(autouse=True)
def _clean_faults():
    for pkg in PACKAGES:
        pkg.faults.clear()
    yield
    for pkg in PACKAGES:
        pkg.faults.clear()


def _wait_for(cond, timeout=20.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


# -- deciders on the same inputs ---------------------------------------------

def _decider_trace(pkg):
    DN, SR, _ = KINDS[pkg.name]
    r = pkg.routing
    nodes = [DN(f"n{i}", f"name{i}", attributes={"zone": "a" if i % 2
                                                 else "b"})
             for i in range(4)]
    usage = {"n0": (10, 100), "n1": (86, 100), "n2": (91, 100),
             "n3": (97, 100)}
    wm = r.WatermarkDecider(lambda nid: usage.get(nid))
    levels = [wm.level(n.node_id) for n in nodes] + [wm.level("nx")]
    wm.set_watermarks("50%", "95b", "99%")
    levels2 = [wm.level(n.node_id) for n in nodes]
    cf = r.ClusterFilterDecider()
    cf.apply_cluster_settings({
        "cluster.routing.allocation.exclude._name": "name1,name3",
        "cluster.routing.allocation.require.zone": None})
    excl = [cf.excludes(n) for n in nodes]
    load = r.LoadDecider({"n0": 1.0, "n1": 9.0}.get, lambda: 2.0)
    loads = [load.can_allocate(None, n, None) for n in nodes]
    shard = SR("i", 0, "", primary=False, state="UNASSIGNED")
    alloc = r.Allocation(nodes=nodes, assigned=[
        SR("i", 0, "n0"), SR("i", 1, "n1", state="INITIALIZING"),
        SR("i", 2, "n1", state="INITIALIZING")])
    chain = r.ShardAllocator([r.SameShardDecider(), r.ThrottlingDecider(2),
                              cf, wm, load])
    verdicts = [chain.decide(shard, n, alloc) for n in nodes]
    verbose = [[d["decision"] for d in chain.decide_verbose(shard, n, alloc)]
               for n in nodes]
    placed = r.ShardAllocator().allocate_index(
        "x", 3, 2, nodes,
        index_settings={"index": {"routing": {"allocation": {
            "exclude": {"zone": "b"}}}}})
    return {"levels": levels, "levels2": levels2, "excl": excl,
            "loads": loads, "verdicts": verdicts, "verbose": verbose,
            "placed": [(s.shard_id, s.primary, s.node_id, s.state)
                       for s in placed],
            "select": [r.select_primary(["a", "b", "c"], ["b", "c"],
                                        {"b": 3, "c": 9}),
                       r.select_primary(["a", "b"], ["a", "b"]),
                       r.select_primary(["a", "b"], []),
                       r.select_primary(["a", "b", "c"], ["b", "c"])]}


def test_deciders_agree_with_the_reference():
    ref, port = (_decider_trace(p) for p in PACKAGES)
    assert port == ref
    assert port["levels"] == ["ok", "low", "high", "flood", "ok"]
    assert port["excl"] == [False, True, False, True]
    assert port["select"][0][0] == "c" and port["select"][2] == []


def test_watermark_reads_the_breakers_capacity(monkeypatch):
    """The watermark grammar resolves percents against the capacity the
    breakers budget (``ESTPU_HBM_BYTES``), the figure each member of a
    shared card holds as its own."""
    from elasticsearch_tpu.resources import breakers as ref_b
    from elasticsearch_tpu_torch.resources import breakers as port_b

    monkeypatch.setenv("ESTPU_HBM_BYTES", str(1 << 30))
    for spec in ("85%", "512mb", "100b", "-1", "0.5"):
        assert port_b.parse_limit(spec, port_b.hbm_capacity()) == \
            ref_b.parse_limit(spec, ref_b.hbm_capacity())
    assert port_b.hbm_capacity() == 1 << 30


# -- cluster scenarios ---------------------------------------------------------

class Members:
    """Members of one package: two to start, more by ``join``."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.nodes, self.clusters = [], []
        self.port = 0
        for rank in range(2):
            self.join(rank)
        self[0].allocator.enabled = False  # the test drives the moves
        self[0].data.create_index("evt", INDEX_BODY)

    def __getitem__(self, i):
        return self.clusters[i]

    def join(self, rank):
        n = self.pkg.node(f"rank{rank}")
        c = self.pkg.cluster(n, rank=rank, world=2,
                             transport_port=self.port, ping_interval=0,
                             minimum_master_nodes=1)
        if rank == 0:
            self.port = addr(c)[1]
        self.nodes.append(n)
        self.clusters.append(c)
        return c

    def rest(self, i, method, path, params=None, body=None):
        ctrl = KINDS[self.pkg.name][2](self[i].node)
        raw = b"" if body is None else json.dumps(body).encode()
        return ctrl.dispatch(method, path, params or {}, raw)

    def write(self, n):
        acked = []
        for i in range(n):
            self[0].data.index_doc("evt", f"d{i}", {"n": i})
            acked.append(f"d{i}")
        self[0].data.refresh("evt")
        return acked

    def served(self, acked, via=0):
        return all(self[via].data.get_doc("evt", d)["found"]
                   for d in acked)

    def close(self):
        self.pkg.faults.clear()
        for c in reversed(self.clusters):
            try:
                c.close()
            except Exception:
                pass
        for n in reversed(self.nodes):
            n.close()


def _both(fn):
    out = {}
    for pkg in PACKAGES:
        m = Members(pkg)
        try:
            out[pkg.name] = fn(m)
        finally:
            m.close()
    return out["ref"], out["port"]


def test_reroute_explain_dry_run_and_move():
    def run(m):
        alloc = m[0].allocator
        c2 = m.join(2)
        acked = m.write(12)
        meta = m[0].dist_indices["evt"]
        src = meta["assignment"]["0"][0]
        dst = c2.local.node_id
        cmd = {"commands": [{"move": {"index": "evt", "shard": 0,
                                      "from_node": src, "to_node": dst}}]}
        st, dry = m.rest(0, "POST", "/_cluster/reroute",
                         {"explain": "true", "dry_run": "true"}, cmd)
        deciders = sorted(d["decider"]
                          for d in dry["explanations"][0]["decisions"])
        unchanged = seats(m[0].dist_indices["evt"]["assignment"])
        bad = {"commands": [{"move": {"index": "evt", "shard": 0,
                                      "from_node": dst, "to_node": src}}]}
        st_bad, res_bad = m.rest(0, "POST", "/_cluster/reroute",
                                 {"explain": "true"}, bad)
        # a member that is not the master forwards the command to it
        st2, res = m.rest(1, "POST", "/_cluster/reroute", {}, cmd)
        _wait_for(lambda: alloc.stats()["inflight"] == 0, msg="the move")
        meta = m[0].dist_indices["evt"]
        return {"dry": (st, dry["acknowledged"], deciders),
                "unchanged": unchanged,
                "bad": (st_bad, res_bad["acknowledged"],
                        res_bad["explanations"][0]["decisions"][0]
                        ["decision"]),
                "move": (st2, res["acknowledged"]),
                "owners0": seats(meta["assignment"]["0"]),
                "in_sync0": sorted(seats(meta["in_sync"]["0"])),
                "served": m.served(acked, via=1),
                "stats": {k: alloc.stats()[k] for k in
                          ("moves_started", "moves_completed",
                           "moves_failed")}}
    ref, port = _both(run)
    assert port == ref
    assert port["dry"][2] == sorted(["same_shard", "cluster_filter",
                                     "watermark", "load", "throttling"])
    assert port["bad"] == (200, False, "NO")
    assert "0002" in port["owners0"] and port["served"]
    assert port["stats"]["moves_completed"] == 1


def test_relocation_stream_fault_cancel_and_reschedule():
    """A move wedged at ``relocation.stream`` stays in flight (its
    target retries); cancelling it with a reschedule lands the copy on
    the one unbanned spare member, and the wedged target never
    graduates."""
    def run(m):
        pkg = m.pkg
        alloc = m[0].allocator
        alloc.RETRY_WAIT_S = 0.02
        c2 = m.join(2)
        c3 = m.join(3)
        acked = m.write(8)
        wedged = c2.local.node_id
        pkg.faults.inject("relocation.stream", error=RuntimeError, count=-1,
                          match=lambda ctx: ctx.get("target") == wedged)
        src = m[0].dist_indices["evt"]["assignment"]["0"][0]
        st, res = m.rest(0, "POST", "/_cluster/reroute", {}, {
            "commands": [{"move": {"index": "evt", "shard": 0,
                                   "from_node": src, "to_node": wedged}}]})
        inflight = [seats(x["target"]) for x in alloc.inflight_snapshot()]
        _wait_for(lambda: alloc.inflight_snapshot()
                  and alloc.inflight_snapshot()[0]["attempts"] >= 2,
                  msg="the wedged stream to retry")
        alloc.cancel_relocation(("evt", 0, wedged), reschedule=True,
                                reason="stalled")
        _wait_for(lambda: alloc.stats()["inflight"] == 0
                  and alloc.stats()["moves_completed"] >= 1,
                  msg="the rescheduled move")
        owners = m[0].dist_indices["evt"]["assignment"]["0"]
        st_ = alloc.stats()
        return {"accepted": (st, res["acknowledged"]),
                "inflight": inflight,
                "owners0": sorted(seats(owners)),
                "wedged_in": wedged in owners,
                "spare_in": c3.local.node_id in owners,
                "counts": (st_["moves_cancelled"] >= 1,
                           st_["reschedules"], st_["moves_completed"]),
                "served": m.served(acked)}
    ref, port = _both(run)
    assert port == ref
    assert port["inflight"] == ["0002"]
    assert not port["wedged_in"] and port["spare_in"] and port["served"]


def test_promotion_on_a_members_death():
    def run(m):
        c2 = m.join(2)
        acked = m.write(20)
        # copies onto the joiner: a replica recovery each way
        directives, changed = m[0].data.reconcile()
        before = json.loads(json.dumps(m[0].dist_indices["evt"]))
        victim = m[1]
        kill(m.pkg, victim)
        for _ in range(m[0]._ping_retries):
            m[0].run_fd_round()
        meta = m[0].dist_indices["evt"]
        promoted = sorted(
            s for s in meta["assignment"]
            if before["assignment"][s][0] == victim.local.node_id)
        return {"members": sorted(seats(list(m[0].node.cluster_state.nodes))),
                "dead_holds": any(victim.local.node_id in o
                                  for o in meta["assignment"].values()),
                "promoted": promoted,
                "terms": {s: (before["primary_terms"][s],
                              meta["primary_terms"][s]) for s in promoted},
                "served": m.served(acked),
                "c2_sees": seats(c2.node.cluster_state.master_node_id)}
    ref, port = _both(run)
    assert port == ref
    assert port["promoted"] and not port["dead_holds"] and port["served"]
    for s, (old, new) in port["terms"].items():
        assert new == old + 1


def test_recovery_on_join_and_rebalance():
    def run(m):
        acked = m.write(24)
        c2 = m.join(2)
        alloc = m[0].allocator
        alloc.enabled = True
        alloc.tick()
        _wait_for(lambda: alloc.stats()["inflight"] == 0
                  and alloc.stats()["moves_started"]
                  == alloc.stats()["moves_completed"]
                  + alloc.stats()["moves_failed"]
                  + alloc.stats()["moves_cancelled"],
                  msg="the rebalance")
        alloc.enabled = False
        meta = m[0].dist_indices["evt"]
        per = {}
        for owners in meta["assignment"].values():
            for o in owners:
                per[seats(o)] = per.get(seats(o), 0) + 1
        recs = [e["type"] for e in
                c2.node.indices["evt"].recoveries.entries()
                if e["stage"] == "done"]
        docs_on_joiner = sum(c2.node.indices["evt"].shards[int(s)]
                             .engine.num_docs
                             for s, o in meta["assignment"].items()
                             if c2.local.node_id in o)
        return {"per_node": per, "recovered": sorted(set(recs)),
                "joiner_has_docs": docs_on_joiner > 0,
                "served": m.served(acked, via=0)}
    ref, port = _both(run)
    assert port == ref
    assert port["per_node"].get("0002", 0) >= 2
    assert port["joiner_has_docs"] and port["served"]


def test_resurrect_lost_adopts_the_member_holding_the_data():
    """A shard whose every copy left the assignment (here: dropped from
    the metadata by hand, its data still on a member's disk copy) is
    re-adopted from the member holding the most docs, under a bumped
    term."""
    def run(m):
        acked = m.write(16)
        with m[0]._indices_lock:
            meta = m[0].dist_indices["evt"]
            holders = list(meta["assignment"]["1"])
            meta["assignment"]["1"] = []
            meta["in_sync"]["1"] = []
            term_before = int(meta["primary_terms"]["1"])
        m[0].data.resurrect_lost()
        meta = m[0].dist_indices["evt"]
        owners = meta["assignment"]["1"]
        return {"owners": len(owners),
                "adopted_holder": bool(owners) and owners[0] in holders,
                "term": int(meta["primary_terms"]["1"]) - term_before,
                "served": m.served(acked)}
    ref, port = _both(run)
    assert port == ref
    assert port["adopted_holder"] and port["term"] >= 1 and port["served"]


def test_allocation_decide_fault_vetoes_a_target():
    """``allocation.decide``: a veto on one target parks the rebalance's
    moves onto it (counted in ``decide_faults``); nothing moves there
    while the fault is armed."""
    def run(m):
        m.write(12)
        c2 = m.join(2)
        target = c2.local.node_id
        m.pkg.faults.inject("allocation.decide", error=RuntimeError,
                            count=-1,
                            match=lambda ctx: ctx.get("target") == target)
        alloc = m[0].allocator
        alloc.enabled = True
        alloc.tick()
        _wait_for(lambda: alloc.stats()["inflight"] == 0, msg="the tick")
        alloc.enabled = False
        meta = m[0].dist_indices["evt"]
        return {"on_target": sum(target in o
                                 for o in meta["assignment"].values()),
                "vetoed": alloc.stats()["decide_faults"] > 0,
                "moves": alloc.stats()["moves_started"]}
    ref, port = _both(run)
    assert port == ref
    assert port["on_target"] == 0 and port["vetoed"]


def test_recovery_shard_sync_fault_keeps_the_copy_out():
    """``recovery.shard_sync``: a new copy whose source fails to stream
    never joins the assignment or the in-sync set; once the fault is
    spent, the same command recovers it."""
    def run(m):
        acked = m.write(12)
        c2 = m.join(2)
        dst = c2.local.node_id
        cmd = {"commands": [{"allocate_replica": {
            "index": "evt", "shard": 1, "node": dst}}]}
        m.pkg.faults.inject("recovery.shard_sync", error=OSError, count=1)
        st, res = m.rest(0, "POST", "/_cluster/reroute", {}, cmd)
        _wait_for(lambda: not m[0].dist_indices["evt"]
                  .get("initializing", {}).get("1"), msg="the failed copy")
        failed = (dst in m[0].dist_indices["evt"]["assignment"]["1"],
                  dst in m[0].dist_indices["evt"]["in_sync"]["1"])
        st2, res2 = m.rest(0, "POST", "/_cluster/reroute", {}, cmd)
        _wait_for(lambda: dst in m[0].dist_indices["evt"]["assignment"]
                  ["1"], msg="the recovered copy")
        return {"first": (st, res["acknowledged"]), "failed": failed,
                "second": (st2, res2["acknowledged"]),
                "in_sync": dst in m[0].dist_indices["evt"]["in_sync"]["1"],
                "served": m.served(acked, via=1)}
    ref, port = _both(run)
    assert port == ref
    assert port["failed"] == (False, False)
    assert port["in_sync"] and port["served"]
