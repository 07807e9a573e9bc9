"""Replicas in the port (``cluster/replication.py``, peer recovery in
``index/recovery.py``, the seq-no pieces of ``index/engine.py``) against
the reference on the CPU.

Every case runs the same seeded writes and bodies through both packages:
- the reference's seq-no and replication unit scenarios
  (``tests/unit/test_seqno.py``, ``tests/unit/test_cluster.py``), each
  run against both packages, their observable results equal: the term
  surviving a reopen, ops and full recoveries with tombstones and the
  prune of stale-era docs, the replay fault point, no-op holes, the
  promotion's term bump and the zombie fence, the fan-out fault;
- fan-out: every copy's location table (version, seq no, term) equal
  to its primary's and to the reference's;
- ``_shards`` on index, delete, update and bulk;
- reads under ``_primary``, ``_replica`` and round-robin, on the mesh
  (the reference's on its 8 virtual CPU devices) and on the host loop,
  ``_msearch`` and the coalescer included: ids, totals exact, scores at
  rtol 1e-5 (the fused-path bar, rtol 5e-3, where the port's B1 served);
- ``fail_shard`` on every shard, scale 0 → 1 → 2 → 0, a gateway restart
  with replicas on a data path, ``stats()`` without its timing fields;
- ROADMAP C15 (a replica that ``number_of_replicas`` adds is never in
  sync in the reference, so it cannot be promoted, and a removed one
  holds the global checkpoint back: the port repairs both), C16 (a
  replica rebuilt by a recovery scores other than its primary: kept, each
  preference held against the reference's same preference) and C17 (the
  reference flushes and merges only primaries: the port reaches every
  copy) and C18 (the reference's promoted copy keeps nothing on disk and
  its failed primary's translog stays open: the port hands the store
  over), each with the reference's own answer asserted;
- the mesh executor with copies: a merge on the primary keeps the
  replica's stacked copies, a promotion is followed, the ``fielddata``
  breaker returns to its starting bytes at the close, and round-robin
  reads with one replica do not thrash the stacked-data LRU.
"""
import copy
import os
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from elasticsearch_tpu.analysis.registry import AnalysisRegistry as RAnalysis
from elasticsearch_tpu.cluster import metadata as ref_md
from elasticsearch_tpu.cluster.replication import ReplicationGroup as RGroup
from elasticsearch_tpu.index import recovery as ref_recovery
from elasticsearch_tpu.index.engine import Engine as REngine
from elasticsearch_tpu.index.index_service import IndexService as RService
from elasticsearch_tpu.index.mappings import Mappings as RMappings
from elasticsearch_tpu.index.shard import IndexShard as RShard
from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu.utils import errors as ref_errors
from elasticsearch_tpu.utils.faults import FAULTS as REF_FAULTS
from elasticsearch_tpu_torch.analysis.registry import AnalysisRegistry
from elasticsearch_tpu_torch.cluster import metadata as port_md
from elasticsearch_tpu_torch.cluster.replication import ReplicationGroup
from elasticsearch_tpu_torch.index import recovery as port_recovery
from elasticsearch_tpu_torch.index.engine import Engine
from elasticsearch_tpu_torch.index.index_service import IndexService
from elasticsearch_tpu_torch.index.mappings import Mappings
from elasticsearch_tpu_torch.index.shard import IndexShard
from elasticsearch_tpu_torch.monitor import kernels
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.resources.residency import Residency
from elasticsearch_tpu_torch.utils import errors as port_errors
from elasticsearch_tpu_torch.utils.faults import FAULTS

from _torch_parity import MAPPING, corpus

CPU = torch.device("cpu")

REF = SimpleNamespace(
    name="ref", errors=ref_errors, faults=REF_FAULTS, group=RGroup,
    recover_peer=ref_recovery.recover_peer, md=ref_md,
    engine=lambda path=None, name="t": REngine(
        RMappings({}), RAnalysis({}), translog_path=path, index_name=name),
    shard=lambda: RShard("rg", 0, RMappings({}), RAnalysis({})),
    service=lambda name, settings, data_path=None: RService(
        name, settings=settings, data_path=data_path))
PORT = SimpleNamespace(
    name="port", errors=port_errors, faults=FAULTS, group=ReplicationGroup,
    recover_peer=port_recovery.recover_peer, md=port_md,
    engine=lambda path=None, name="t": Engine(
        Mappings({}), AnalysisRegistry({}), Residency(CPU),
        translog_path=path, index_name=name),
    shard=lambda: IndexShard("rg", 0, Mappings({}), AnalysisRegistry({}),
                             Residency(CPU)),
    service=lambda name, settings, data_path=None: IndexService(
        name, Residency(CPU), settings=settings, data_path=data_path))

N_DOCS = 240
BODIES = [
    {"query": {"match": {"body": "river mountain valley"}}, "size": 8},
    {"query": {"match": {"body": "apple banana cherry"}}, "size": 5,
     "from": 2},
    {"query": {"term": {"tag": "t3"}}, "size": 6},
    {"query": {"bool": {"should": [{"match": {"body": "fox ocean"}}],
                        "filter": [{"range": {"n": {"gte": 0}}}]}},
     "size": 7},
    {"query": {"match_all": {}}, "size": 4},
]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    from elasticsearch_tpu.parallel import aot

    monkeypatch.setattr(aot, "_ENABLED", False)
    for f in (REF_FAULTS, FAULTS):
        f.clear()
    yield
    for f in (REF_FAULTS, FAULTS):
        f.clear()


def _both(scenario, tmp_path):
    """The scenario's observable result in each package; they must be
    equal. Returns it."""
    out = {}
    for pkg in (REF, PORT):
        d = tmp_path / pkg.name
        d.mkdir()
        out[pkg.name] = scenario(pkg, str(d))
    assert out["port"] == out["ref"]
    return out["port"]


def _tl(root, name):
    return os.path.join(root, name, "translog")


# -- the reference's seq-no scenarios, run against both packages --------------

def _term_survives_reopen(pkg, root):
    e = pkg.engine(_tl(root, "t"))
    e.index("a", {"v": 1})
    e.bump_term(5)
    e.index("b", {"v": 2})
    term_b = e._locations["b"].term
    e.close()
    e2 = pkg.engine(_tl(root, "t"))
    e2.recover_from_translog()
    try:
        e2.index("c", {"v": 3}, primary_term=4)
        fenced = False
    except pkg.errors.StalePrimaryException as ex:
        fenced = (ex.status, ex.error_type)
    out = (term_b, e2.primary_term, e2.local_checkpoint, e2.term_at(0),
           e2.term_at(1), fenced, e2.exists("c"))
    e2.close()
    return out


def _ops_recovery(pkg, root):
    src = pkg.engine(_tl(root, "src"), "src")
    for i in range(10):
        src.index(str(i), {"v": i})
    dst = pkg.engine(None, "dst")
    a = pkg.recover_peer(src, dst)
    first = (a["mode"], a["ops_replayed"], dst.num_docs,
             dst.local_checkpoint)
    for i in range(10, 15):
        src.index(str(i), {"v": i})
    b = pkg.recover_peer(src, dst)
    out = (first, b["mode"], b["ops_replayed"], dst.num_docs,
           sorted((d, l.version, l.seq_no, l.term)
                  for d, l in dst._locations.items()))
    src.close()
    dst.close()
    return out


def _full_copy_with_tombstones(pkg, root):
    src = pkg.engine(_tl(root, "src"), "src")
    for i in range(6):
        src.index(str(i), {"v": i})
    dst = pkg.engine(None, "dst")
    pkg.recover_peer(src, dst)
    held = dst.exists("3")
    src.delete("3")
    src.flush()  # the commit drops the retained ops
    st = pkg.recover_peer(src, dst)
    out = (held, st["mode"], st["copied"], dst.exists("3"), dst.num_docs,
           dst.local_checkpoint, dst._locations["3"].deleted)
    src.close()
    dst.close()
    return out


def _full_copy_prunes_stale_era(pkg, root):
    src = pkg.engine(_tl(root, "src"), "src")
    for i in range(4):
        src.index(str(i), {"v": i})
    dst = pkg.engine(None, "dst")
    pkg.recover_peer(src, dst)
    dst.index("zombie", {"v": 99})  # a diverged old-term write
    src.bump_term(2)
    src.index("new", {"v": 5})
    st = pkg.recover_peer(src, dst)
    mid = (st["mode"], dst.exists("zombie"), dst.exists("new"),
           dst.primary_term, dst.local_checkpoint == src.local_checkpoint)
    src.index("after", {"v": 6})
    st2 = pkg.recover_peer(src, dst)
    out = (mid, st2["mode"], st2["ops_replayed"])
    src.close()
    dst.close()
    return out


def _ops_replay_fault(pkg, root):
    src = pkg.engine(_tl(root, "src"), "src")
    for i in range(3):
        src.index(str(i), {"v": i})
    dst = pkg.engine(None, "dst")
    seen = []

    def second_op(ctx):
        seen.append(ctx["seq_no"])
        return ctx["seq_no"] == 1

    pkg.faults.inject("recovery.ops_replay", error=OSError, count=1,
                      match=second_op)
    try:
        pkg.recover_peer(src, dst)
        raised = False
    except OSError:
        raised = True
    pkg.faults.clear()
    already = dst.local_checkpoint
    st = pkg.recover_peer(src, dst)
    out = (raised, seen, already, st["mode"], st["ops_replayed"],
           dst.num_docs)
    src.close()
    dst.close()
    return out


def _skipped_op_is_a_noop(pkg, root):
    src = pkg.engine(_tl(root, "src"), "src")
    for i in range(5):
        src.index(str(i), {"v": i})
    dst = pkg.engine(None, "dst")
    pkg.recover_peer(src, dst)
    src.index("0", {"v": 100})
    src.index("0", {"v": 200})
    dst.index("0", {"v": 200}, version=3, version_type="external_gte",
              seq_no=6, primary_term=1, _replay=True)
    held = dst.local_checkpoint
    st = pkg.recover_peer(src, dst)
    out = (held, st["mode"], st["skipped"], dst.local_checkpoint,
           dst.get("0")["_version"])
    src.close()
    dst.close()
    return out


def _promotion_fences_zombie(pkg, root):
    p, r1, r2 = pkg.shard(), pkg.shard(), pkg.shard()
    g = pkg.group(0, p, [r1, r2])
    for i in range(5):
        g.index(str(i), {"v": i})
    gcp = g.global_checkpoint
    old = g.primary
    promoted = g.fail_primary()
    zombie = pkg.group(0, old, [promoted, r2])
    try:
        zombie.index("late", {"v": 99})
        fenced = False
    except pkg.errors.StalePrimaryException:
        fenced = True
    g.index("ok", {"v": 1})
    return (gcp, promoted is r1, g.primary_term, fenced,
            promoted.engine.exists("late"), r2.engine.exists("late"),
            old.engine.exists("late"), promoted.engine._locations["ok"].term,
            r2.engine._locations["ok"].term)


def _fanout_fault_demotes_copy(pkg, root):
    p, r1 = pkg.shard(), pkg.shard()
    g = pkg.group(0, p, [r1])
    pkg.faults.inject("replication.fanout", error=OSError, count=1)
    _rid, _v, _c, failed, seq_no, term = g.index("a", {"v": 1})
    out = [failed, seq_no, term, r1 in g.failed_replicas,
           r1.engine.commit_id in g.checkpoints.in_sync]
    try:
        g.fail_primary()
        out.append("promoted")
    except pkg.errors.ElasticsearchTpuException as e:
        out.append(str(e))
    return tuple(out)


SCENARIOS = {
    "term_survives_reopen": (_term_survives_reopen,
                             (5, 5, 1, 1, 5, (409, "stale_primary_exception"),
                              False)),
    "ops_recovery": (_ops_recovery, None),
    "full_copy_with_tombstones": (_full_copy_with_tombstones,
                                  (True, "full", 5, False, 5, 6, True)),
    "full_copy_prunes_stale_era": (_full_copy_prunes_stale_era,
                                   (("full", False, True, 2, True),
                                    "ops", 1)),
    "ops_replay_fault": (_ops_replay_fault,
                         (True, [0, 1], 0, "ops", 2, 3)),
    "skipped_op_is_a_noop": (_skipped_op_is_a_noop,
                             (4, "ops", 1, 6, 3)),
    "promotion_fences_zombie": (_promotion_fences_zombie,
                                (4, True, 2, True, False, False, True, 2,
                                 2)),
    "fanout_fault_demotes_copy": (_fanout_fault_demotes_copy,
                                  (1, 0, 1, True, False,
                                   "shard [0]: no in-sync replica to "
                                   "promote")),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_seqno_scenario_matches_the_reference(name, tmp_path):
    scenario, want = SCENARIOS[name]
    got = _both(scenario, tmp_path)
    if want is not None:
        assert got == want
    if name == "ops_recovery":
        assert got[0] == ("ops", 10, 10, 9) and got[1:4] == ("ops", 5, 15)


# -- the index service: fan-out, _shards, failover ------------------------------

def _service(pkg, shards=2, replicas=1, n=N_DOCS, refresh_every=40):
    svc = pkg.service("rep", {"index": {"number_of_shards": shards,
                                        "number_of_replicas": replicas}})
    for i, (doc_id, src) in enumerate(corpus(n, seed=5)):
        svc.index_doc(doc_id, copy.deepcopy(src))
        if i % refresh_every == refresh_every - 1:
            svc.refresh()
    for i in range(0, n, 23):
        svc.delete_doc(f"d{i}")
    svc.refresh()
    return svc


def _table(engine):
    return sorted((d, l.version, l.seq_no, l.term, l.deleted)
                  for d, l in engine._locations.items())


def test_writes_fan_out_with_the_primarys_identity():
    ref, port = _service(REF), _service(PORT)
    try:
        for rg, pg in zip(ref.groups, port.groups):
            assert len(pg.replicas) == len(rg.replicas) == 1
            want = _table(rg.primary.engine)
            assert _table(rg.replicas[0].engine) == want
            assert _table(pg.primary.engine) == want
            assert _table(pg.replicas[0].engine) == want
            # fan-out copies keep the same segment layout
            assert [s.num_docs for s in pg.replicas[0].segments] == \
                [s.num_docs for s in pg.primary.segments]
            assert pg.global_checkpoint == rg.global_checkpoint \
                == pg.primary.engine.max_seq_no
    finally:
        ref.close()
        port.close()


def _write(svc, op):
    if op == "index":
        return svc.index_doc("w1", {"body": "fox", "tag": "t1"})
    if op == "delete":
        return svc.delete_doc("d5")
    if op == "update":
        return svc.update_doc("d7", {"doc": {"tag": "upd"}})
    raise AssertionError(op)


@pytest.mark.parametrize("op", ["index", "delete", "update", "bulk"])
def test_shards_header_of_each_write(op):
    ref = RefNode(name="r")
    port = Node(name="p", device="cpu")
    try:
        out = {}
        for node in (ref, port):
            node.create_index("rep", {"settings": {
                "number_of_shards": 2, "number_of_replicas": 1},
                "mappings": MAPPING})
            svc = node.indices["rep"]
            for doc_id, src in corpus(30, seed=5):
                svc.index_doc(doc_id, copy.deepcopy(src))
            if op == "bulk":
                r = node.bulk([{"index": {"_index": "rep", "_id": "b1"}},
                               {"body": "fox"},
                               {"update": {"_index": "rep", "_id": "d3"}},
                               {"doc": {"tag": "u"}},
                               {"delete": {"_index": "rep", "_id": "d4"}},
                               {"create": {"_index": "rep", "_id": "d1"}},
                               {"body": "taken"}])
                got = [(o, it[o].get("_shards"), it[o]["status"],
                        it[o].get("_version"), it[o].get("_seq_no"),
                        it[o].get("_primary_term"))
                       for it in r["items"] for o in it]
            else:
                r = _write(svc, op)
                got = (r["_shards"], r["_version"], r.get("_seq_no"),
                       r.get("_primary_term"), r["result"])
            g = svc.group_for("d7" if op == "update" else "w1")
            out[node is port] = (got, _table(g.replicas[0].engine))
        assert out[True] == out[False]
        if op != "bulk":
            assert out[True][0][0] == {"total": 2, "successful": 2,
                                       "failed": 0}
    finally:
        ref.close()
        port.close()


def _poisoned_replica(pkg, root):
    svc = pkg.service("rf", {"index": {"number_of_replicas": 1}})
    group = svc.groups[0]
    group.replicas[0].engine.index = None  # its next index op raises
    r = svc.index_doc("1", {"v": 1})
    out = (r["_shards"], len(group.replicas), len(group.failed_replicas))
    svc.close()
    return out


def test_a_failing_replica_is_counted_in_shards(tmp_path):
    assert _both(_poisoned_replica, tmp_path) == (
        {"total": 2, "successful": 1, "failed": 1}, 0, 1)


def _update_replicates(pkg, root):
    svc = _service(pkg, n=60)
    svc.update_doc("d3", {"doc": {"extra": "yes"}})
    g = svc.group_for("d3")
    out = (g.replicas[0].engine.get("d3")["_source"],
           _table(g.replicas[0].engine) == _table(g.primary.engine))
    svc.close()
    return out


def test_an_update_fans_out_the_merged_doc(tmp_path):
    src, same = _both(_update_replicates, tmp_path)
    assert src["extra"] == "yes" and same


def _failover(pkg, root):
    svc = _service(pkg, n=80)
    body = {"query": {"match_all": {}}, "size": 0}
    out = []
    for sid in range(svc.num_shards):
        old = svc.shards[sid]
        new = svc.fail_shard(sid)
        out.append((new is not old, new.engine.primary_term,
                    svc.groups[sid].replicas == []))
    total = svc.search(body, preference="_primary")["hits"]["total"]
    r = svc.index_doc("after", {"body": "fox"})
    svc.refresh()
    out.append((total, r["_primary_term"], r["_shards"],
                svc.search(body)["hits"]["total"]))
    svc.close()
    return out


def test_fail_shard_promotes_and_bumps_the_term(tmp_path):
    got = _both(_failover, tmp_path)
    assert got[0] == (True, 2, True) and got[-1][1] == 2


# -- reads under each preference, on both routes ------------------------------------

def _load(node, name, replicas, scale=None):
    node.create_index(name, {"settings": {
        "number_of_shards": 2, "number_of_replicas": replicas},
        "mappings": MAPPING})
    svc = node.indices[name]
    for i, (doc_id, src) in enumerate(corpus(N_DOCS, seed=9)):
        svc.index_doc(doc_id, copy.deepcopy(src))
        if i % 40 == 39:
            svc.refresh()
    for i in range(0, N_DOCS, 19):
        svc.delete_doc(f"d{i}")
    svc.refresh()
    for n in scale or ():
        _scale(node, name, n)


def _scale(node, name, n):
    """``number_of_replicas: n`` (the reference's Node has no settings
    method: its metadata module's)."""
    md = port_md if isinstance(node, Node) else ref_md
    md.update_index_settings(node.indices[name], {"number_of_replicas": n},
                             node=node)


@pytest.fixture(scope="module")
def nodes():
    """``r``: two shards and one fan-out replica each; ``c``: the same
    writes, its replica rebuilt by a recovery after scaling 1 → 0 → 1
    (C16: one segment a shard where the primary keeps several)."""
    from elasticsearch_tpu.parallel import aot

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(aot, "_ENABLED", False)
        ref, port = RefNode(name="r"), Node(name="p", device="cpu")
        for node in (ref, port):
            _load(node, "r", 1)
            _load(node, "c", 1, scale=(0, 1))
        yield ref, port
    ref.close()
    port.close()


def _sig(resp):
    return resp["hits"]["total"], [h["_id"] for h in resp["hits"]["hits"]]


def _check(p, r, fused: bool):
    """Total exact; the same ids and scores at rtol 1e-5, or, where the
    port's B1 served (bf16 impacts), the fused-path bar."""
    assert p["hits"]["total"] == r["hits"]["total"]
    assert p["_shards"] == r["_shards"]
    ps = np.array([h["_score"] for h in p["hits"]["hits"]], np.float64)
    rs = np.array([h["_score"] for h in r["hits"]["hits"]], np.float64)
    if fused:
        assert len(ps) == len(rs)
        np.testing.assert_allclose(ps, rs, rtol=5e-3)
        pid, rid = _sig(p)[1], _sig(r)[1]
        assert len(set(pid) & set(rid)) / max(len(rid), 1) >= 0.8
        return
    assert _sig(p) == _sig(r)
    np.testing.assert_allclose(ps, rs, rtol=1e-5)


def _port_search(port, index, body, pref):
    kernels.reset()
    resp = port.search(index, copy.deepcopy(body), preference=pref)
    return resp, bool(kernels.snapshot().get("bm25_fused_topk"))


@pytest.mark.parametrize("mesh", [True, False])
@pytest.mark.parametrize("pref", ["_primary", "_replica", None])
def test_reads_under_each_preference_match_the_reference(nodes, mesh, pref,
                                                         monkeypatch):
    ref, port = nodes
    if not mesh:
        monkeypatch.setenv("ESTPU_DISABLE_MESH", "1")
    for index in ("r", "c"):
        # two passes: round-robin reads each copy once per body
        for body in BODIES + BODIES:
            p, fused = _port_search(port, index, body, pref)
            r = ref.search(index, copy.deepcopy(body), preference=pref)
            _check(p, r, fused)
            if mesh and index == "r":
                assert kernels.snapshot().get("mesh_search") == 1


def test_round_robin_turns_once_per_shard_and_request(nodes):
    ref, port = nodes
    for node in (ref, port):
        for _ in range(5):
            node.search("r", copy.deepcopy(BODIES[2]))

    def per_copy(node):
        return [[c.searcher.stats.to_json()["query_total"]
                 for c in g.copies] for g in node.indices["r"].groups]

    got, want = per_copy(port), per_copy(ref)
    assert got == want
    assert all(min(c) > 0 for c in got)


def test_c16_a_rebuilt_replica_scores_apart_from_its_primary(nodes):
    """C16, kept: the recovered replica of ``c`` holds one segment a shard
    and scores by its own statistics, so ``_replica`` answers otherwise
    than ``_primary`` in both packages; each preference equals the
    reference's (the parametrised reads above)."""
    ref, port = nodes
    body = {"query": {"match": {"body": "river mountain valley"}},
            "size": 10}
    for node in (ref, port):
        svc = node.indices["c"]
        assert all(len(g.replicas[0].segments) == 1
                   and len(g.primary.segments) > 1 for g in svc.groups)
        a = node.search("c", copy.deepcopy(body), preference="_primary")
        b = node.search("c", copy.deepcopy(body), preference="_replica")
        assert a["hits"]["total"] == b["hits"]["total"]
        assert [h["_score"] for h in a["hits"]["hits"]] != \
            [h["_score"] for h in b["hits"]["hits"]]
    for pref in ("_primary", "_replica"):
        p = port.search("c", copy.deepcopy(body), preference=pref)
        r = ref.search("c", copy.deepcopy(body), preference=pref)
        _check(p, r, False)


@pytest.mark.parametrize("pref", [None, "_replica"])
def test_msearch_reads_the_preferred_copies(nodes, pref):
    ref, port = nodes
    pairs = [({"index": "c"}, {"query": {"match": {"body": w}}, "size": 6})
             for w in ("river", "apple banana", "mountain", "ocean fox",
                       "valley", "cherry")]
    got = port.msearch(copy.deepcopy(pairs), preference=pref)["responses"]
    if pref is None:
        want = ref.msearch(copy.deepcopy(pairs))["responses"]
    else:
        want = [ref.search("c", copy.deepcopy(b), preference=pref)
                for _h, b in pairs]
    for p, r in zip(got, want):
        _check(p, r, False)
    # a header's preference overrides the argument
    hdr = [(dict(h, preference="_primary"), b) for h, b in pairs]
    got = port.msearch(copy.deepcopy(hdr), preference=pref)["responses"]
    for p, (_h, b) in zip(got, pairs):
        _check(p, ref.search("c", copy.deepcopy(b), preference="_primary"),
               False)


def test_the_coalescer_batches_replica_reads(nodes):
    ref, port = nodes
    port.serving.apply_cluster_settings({
        "serving.coalescer.mode": "always",
        "serving.coalescer.max_wait": "200ms",
        "serving.coalescer.idle_gap": "50ms"})
    try:
        bodies = [{"query": {"match": {"body": w}}, "size": 5}
                  for w in ("river", "mountain", "valley", "ocean",
                            "apple", "banana")]
        before = [c.searcher.stats.to_json()["query_total"]
                  for g in port.indices["r"].groups for c in g.copies]
        flushes = sum(port.serving.coalescer.stats()["flushes"].values())
        out = [None] * len(bodies)
        barrier = threading.Barrier(len(bodies))

        def client(i):
            barrier.wait(timeout=60)
            out[i] = port.search("r", copy.deepcopy(bodies[i]))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert sum(port.serving.coalescer.stats()["flushes"].values()) \
            > flushes
        for p, b in zip(out, bodies):
            _check(p, ref.search("r", copy.deepcopy(b),
                                 preference="_primary"), False)
        after = [c.searcher.stats.to_json()["query_total"]
                 for g in port.indices["r"].groups for c in g.copies]
        assert sum(after) - sum(before) == len(bodies) * 2
    finally:
        port.serving.apply_cluster_settings({})


def test_stats_sum_search_over_copies_and_carry_seq_no(nodes):
    ref, port = nodes

    def view(svc):
        st = svc.stats()
        return [{"search": {k: s["search"][k] for k in (
                    "query_total", "fetch_total", "suggest_total",
                    "scroll_total")},
                 "docs": s["docs"]["count"],
                 "indexing": (s["indexing"]["index_total"],
                              s["indexing"]["delete_total"]),
                 "seq_no": s["seq_no"]}
                for _sh, s in sorted(st["shards"].items())]

    for node in (ref, port):
        for b in BODIES:
            node.search("r", copy.deepcopy(b))
    got, want = view(port.indices["r"]), view(ref.indices["r"])
    assert got == want
    assert all(set(v["seq_no"]) == {"max_seq_no", "local_checkpoint",
                                    "primary_term", "global_checkpoint"}
               for v in got)
    ns = port.nodes_stats()["nodes"][port.node_id]["indices"]
    copies = [c for svc in port.indices.values() for g in svc.groups
              for c in g.copies]
    assert ns["segments"]["count"] == sum(len(c.segments) for c in copies)
    assert ns["search"]["query_total"] == sum(
        c.searcher.stats.query_total for c in copies)


# -- scaling, restarts, C15, C17 ---------------------------------------------------------

def test_scale_replicas_0_1_2_0_matches_the_reference():
    ref = RefNode(name="r")
    port = Node(name="p", device="cpu")
    body = {"query": {"match": {"body": "river apple"}}, "size": 10}
    try:
        for node in (ref, port):
            _load(node, "s", 0)
        for n in (1, 2, 0):
            for node in (ref, port):
                _scale(node, "s", n)
                node.indices["s"].index_doc(f"n{n}", {"body": "river"})
                node.indices["s"].refresh()
            for rg, pg in zip(ref.indices["s"].groups,
                              port.indices["s"].groups):
                assert len(pg.replicas) == len(rg.replicas) == n
                for rc, pc in zip(rg.replicas, pg.replicas):
                    assert _table(pc.engine) == _table(rc.engine) == \
                        _table(pg.primary.engine)
            for pref in ("_primary", "_replica", None):
                p, fused = _port_search(port, "s", body, pref)
                _check(p, ref.search("s", copy.deepcopy(body),
                                     preference=pref), fused)
        entries = port.indices["s"].recoveries.entries()
        assert [e["type"] for e in entries] == ["replica"] * 4
        assert all(e["mode"] == "ops" and e["stage"] == "done"
                   for e in entries)
        # the reference records no recovery of a scaled replica (C15)
        assert ref.indices["s"].recoveries.entries() == []
        assert port.get_index("s").settings["index"][
            "number_of_replicas"] == 0
    finally:
        ref.close()
        port.close()


def test_c15_a_scaled_replica_is_in_sync_and_promotable(tmp_path):
    """C15: the reference's ``_scale_replicas`` never touches the in-sync
    set. A replica it adds cannot be promoted (its answer pinned), and a
    replica it removes holds the global checkpoint back; the port marks
    the recovered copy in sync and drops the removed one."""
    def scaled(pkg, root):
        svc = pkg.service("c15", {"index": {"number_of_shards": 1,
                                            "number_of_replicas": 0}})
        for i in range(5):
            svc.index_doc(str(i), {"v": i})
        pkg.md.update_index_settings(svc, {"number_of_replicas": 1})
        g = svc.groups[0]
        out = [len(g.checkpoints.in_sync),
               [(e["type"], e["mode"]) for e in svc.recoveries.entries()]]
        try:
            svc.fail_shard(0)
            out.append(("promoted", svc.shards[0].engine.primary_term))
        except pkg.errors.ElasticsearchTpuException as e:
            out.append(str(e))
        svc.close()
        shrink = pkg.service("gs", {"index": {"number_of_shards": 1,
                                              "number_of_replicas": 1}})
        for i in range(5):
            shrink.index_doc(str(i), {"v": i})
        pkg.md.update_index_settings(shrink, {"number_of_replicas": 0})
        for i in range(5, 9):
            shrink.index_doc(str(i), {"v": i})
        out.append(shrink.groups[0].global_checkpoint)
        shrink.close()
        return out

    d = tmp_path
    assert scaled(REF, str(d)) == [
        1, [], "shard [0]: no in-sync replica to promote", 4]
    assert scaled(PORT, str(d)) == [2, [("replica", "ops")],
                                    ("promoted", 2), 8]


@pytest.mark.parametrize("flush", [False, True])
def test_c18_a_failover_on_a_data_path_keeps_acknowledged_writes(tmp_path,
                                                                  flush):
    """C18: on a data path the reference promotes a copy with no store and
    leaves the failed primary's translog open, so at a restart the writes
    acknowledged after the failover are gone and a stale group's write
    comes back (pinned). The port fails the old primary's engine and
    hands its translog and commit to the promoted copy, which commits
    before its first write: the acknowledged writes come back, under
    their term, with or without a flush, and the stale write is refused
    and never lands."""
    body = {"query": {"match_all": {}}, "size": 0}
    got = {}
    for cls, kw, pkg in ((RefNode, {}, REF),
                         (Node, {"device": "cpu"}, PORT)):
        path = str(tmp_path / pkg.name)
        node = cls(name="a", data_path=path, **kw)
        node.create_index("d", {"settings": {
            "number_of_shards": 1, "number_of_replicas": 1},
            "mappings": MAPPING})
        svc = node.indices["d"]
        for i in range(5):
            svc.index_doc(f"pre{i}", {"body": "river"})
        old = svc.groups[0].primary
        promoted = svc.fail_shard(0)
        try:
            pkg.group(0, old, [promoted]).index("zombie", {"body": "late"})
            zombie = "acknowledged"
        except Exception as e:  # the type is what differs
            zombie = type(e).__name__
        term = svc.index_doc("post", {"body": "fox"})["_primary_term"]
        svc.delete_doc("pre0")
        if flush:
            svc.flush()
        node.close()
        again = cls(name="b", data_path=path, **kw)
        try:
            eng = again.indices["d"].groups[0].primary.engine
            got[pkg.name] = (
                zombie, term, old.engine.exists("zombie"),
                sorted((d, l.term) for d, l in eng._locations.items()
                       if not l.deleted),
                eng.primary_term,
                [again.search("d", copy.deepcopy(body),
                              preference=p)["hits"]["total"]
                 for p in ("_primary", "_replica")])
        finally:
            again.close()
    assert got["port"] == (
        "EngineFailedException", 2, False,
        [("post", 2)] + [(f"pre{i}", 1) for i in range(1, 5)], 2, [5, 5])
    ref = got["ref"]
    assert ref[0] == "StalePrimaryException" and ref[2]
    assert ("post", 2) not in ref[3] and ("zombie", 1) in ref[3]


def test_the_local_replicas_marker_is_popped_and_ignored():
    """The ``_local_replicas`` marker, set by cluster members whose
    replicas are copies held by other members
    (cluster/search_action.py), is popped, never echoed, and honoured as
    the reference honours it: the member builds that many in-process
    copies (here none), while ``number_of_replicas`` and a write's
    ``_shards.total`` keep the declared count. Without the marker every
    declared copy is built."""
    for pkg in (REF, PORT):
        svc = pkg.service("lr", {"index": {"number_of_shards": 1,
                                           "number_of_replicas": 1,
                                           "_local_replicas": 0}})
        try:
            assert "_local_replicas" not in svc.settings["index"]
            assert svc.num_replicas == 1
            assert len(svc.groups[0].replicas) == 0
            assert svc.index_doc("a", {"v": 1})["_shards"] == {
                "total": 2, "successful": 1, "failed": 0}
        finally:
            svc.close()
    svc = PORT.service("lr2", {"index": {"number_of_shards": 1,
                                         "number_of_replicas": 1}})
    try:
        assert len(svc.groups[0].replicas) == 1
        assert svc.index_doc("a", {"v": 1})["_shards"] == {
            "total": 2, "successful": 2, "failed": 0}
        assert svc.fail_shard(0).engine.exists("a")
    finally:
        svc.close()


def test_a_fault_point_the_port_never_checks_is_refused():
    """``inject`` accepts only the points the code checks: a spec naming
    another fails loudly instead of never firing. The port checks every
    point the reference does, so both registries refuse the same name
    and accept the translog's."""
    for reg in (FAULTS, REF_FAULTS):
        with pytest.raises(ValueError, match="unknown fault point"):
            reg.inject("translog.truncate", count=1)
        reg.inject("translog.append", count=1)
        assert reg.active("translog.append")
        reg.clear("translog.append")


def test_c17_flush_and_force_merge_reach_every_copy():
    """C17: the reference flushes and force-merges the primaries only, so
    a replica misses flushed docs until the next refresh and keeps its
    segments after an ``_optimize`` (pinned); the port reaches every
    copy."""
    body = {"query": {"match_all": {}}, "size": 0}
    out = {}
    for pkg in (REF, PORT):
        svc = pkg.service("fl", {"index": {"number_of_shards": 1,
                                           "number_of_replicas": 1}})
        for i in range(5):
            svc.index_doc(str(i), {"body": "fox"})
        svc.flush()
        seen = [svc.search(body, preference=p)["hits"]["total"]
                for p in ("_primary", "_replica")]
        for i in range(3):
            svc.index_doc(f"y{i}", {"body": "fox"})
            svc.refresh()
        svc.force_merge(1)
        g = svc.groups[0]
        out[pkg.name] = (seen, len(g.primary.segments),
                         len(g.replicas[0].segments))
        svc.close()
    assert out["ref"] == ([5, 0], 1, 3)
    assert out["port"] == ([5, 5], 1, 1)


@pytest.mark.parametrize("flush", [False, True])
def test_a_restart_rebuilds_and_resyncs_the_replicas(tmp_path, flush):
    """The gateway rebuilds each index's replicas from ``_meta.json`` and
    re-syncs them from the recovered primaries: by the ops when the
    primary's translog covers its history, by a full copy after a flush.
    After a flush the reference comes back empty (its C12), so there the
    port is held against its own answers before the restart."""
    body = {"query": {"match": {"body": "river mountain"}}, "size": 8}

    def tables(svc):
        return [(_table(g.primary.engine),
                 [_table(r.engine) for r in g.replicas])
                for g in svc.groups]

    def reads(node):
        return [node.search("g", copy.deepcopy(body), preference=p)
                for p in ("_primary", "_replica")]

    got = {}
    for cls, kw, tag in ((RefNode, {}, "ref"),
                         (Node, {"device": "cpu"}, "port")):
        path = str(tmp_path / tag)
        node = cls(name="a", data_path=path, **kw)
        _load(node, "g", 1)
        if flush:
            node.indices["g"].flush()
        before = (tables(node.indices["g"]), reads(node))
        node.close()
        again = cls(name="b", data_path=path, **kw)
        try:
            svc = again.indices["g"]
            got[tag] = {
                "before": before, "tables": tables(svc),
                "types": sorted(e["type"] for e in svc.recoveries.entries()),
                "reads": reads(again),
                "modes": [e["mode"] for e in svc.recoveries.entries()
                          if e["type"] == "replica"],
            }
        finally:
            again.close()
    p, r = got["port"], got["ref"]
    assert [prim for prim, _r in p["tables"]] == \
        [prim for prim, _r in p["before"][0]]
    for prim, reps in p["tables"]:
        if flush:
            # a full copy carries no tombstone of a doc its target never
            # held: the live entries agree
            prim = [e for e in prim if not e[4]]
        assert reps == [prim]
    assert p["types"] == r["types"] == ["gateway", "gateway", "replica",
                                        "replica"]
    assert p["modes"] == [("full" if flush else "ops")] * 2
    if not flush:
        assert p["tables"] == r["tables"]
        for pa, ra in zip(p["reads"], r["reads"]):
            _check(pa, ra, False)
        return
    assert all(not prim for prim, _reps in r["tables"])  # C12, pinned
    _check(p["reads"][0], p["before"][1][0], False)
    # the full copy's replica: one segment, its own statistics (C16)
    assert p["reads"][1]["hits"]["total"] == p["before"][1][1]["hits"][
        "total"]


# -- the mesh executor with copies ------------------------------------------------------

def _mesh_index(node, name="m", replicas=1):
    node.create_index(name, {"settings": {
        "number_of_shards": 2, "number_of_replicas": replicas},
        "mappings": MAPPING})
    svc = node.indices[name]
    for i, (doc_id, src) in enumerate(corpus(160, seed=4)):
        svc.index_doc(doc_id, copy.deepcopy(src))
        if i % 40 == 39:
            svc.refresh()
    svc.refresh()
    return svc


GENERIC = {"query": {"bool": {"must": [{"match": {"body": "river"}}],
                              "filter": [{"term": {"tag": "t2"}}]}},
           "size": 5}


def test_a_primary_merge_keeps_the_replicas_stacked_copies():
    port = Node(name="p", device="cpu")
    try:
        svc = _mesh_index(port)
        port.search("m", copy.deepcopy(GENERIC), preference="_replica")
        port.search("m", copy.deepcopy(GENERIC), preference="_primary")
        ex = svc.mesh_executor()
        rep_segs = {id(s) for g in svc.groups for s in g.replicas[0].segments}
        prim_segs = {id(s) for g in svc.groups for s in g.primary.segments}
        assert rep_segs <= ex.cached_segments()
        assert prim_segs <= ex.cached_segments()
        for g in svc.groups:
            g.primary.engine.merge()
        svc._drop_retired()
        held = ex.cached_segments()
        assert rep_segs <= held
        assert not (prim_segs & held)
        # the replica's copies still answer, from the cache
        kernels.reset()
        port.search("m", copy.deepcopy(GENERIC), preference="_replica")
        snap = kernels.snapshot()
        assert snap.get("mesh_search") == 1
        assert snap.get("executor_data_hit", 0) > 0
        assert not snap.get("executor_data_miss")
    finally:
        port.close()


def test_the_mesh_follows_a_promotion_and_releases_at_close():
    ref = RefNode(name="r")
    port = Node(name="p", device="cpu")
    fd = port.breakers.breaker("fielddata")
    start = fd.used
    try:
        for node in (ref, port):
            _mesh_index(node)
            node.search("m", copy.deepcopy(GENERIC))
            node.search("m", copy.deepcopy(GENERIC))
        svc = port.indices["m"]
        ex = svc.mesh_executor()
        for node in (ref, port):
            for sid in range(2):
                node.indices["m"].fail_shard(sid)
        assert ex.shards == svc.shards
        assert all(sh is g.primary for sh, g in zip(ex.shards, svc.groups))
        old = {id(s) for g in svc.groups for c in g.failed_replicas
               for s in c.segments}
        assert not (old & ex.cached_segments())
        for body in (GENERIC, BODIES[0], BODIES[3]):
            kernels.reset()
            p = port.search("m", copy.deepcopy(body))
            assert kernels.snapshot().get("mesh_search") == 1
            _check(p, ref.search("m", copy.deepcopy(body)), False)
        r = port.index("m", "late", {"body": "river", "tag": "t2"})
        assert r["_primary_term"] == 2 and r["_shards"] == {
            "total": 2, "successful": 1, "failed": 0}
        assert fd.used > start
        port.delete_index("m")
        assert fd.used == start
    finally:
        ref.close()
        port.close()


def test_round_robin_with_one_replica_does_not_thrash_the_lru():
    port = Node(name="p", device="cpu")
    try:
        svc = _mesh_index(port)
        bodies = [GENERIC, dict(GENERIC, query={"bool": {
            "must": [{"match": {"body": "ocean"}}],
            "filter": [{"range": {"n": {"gte": 0}}}]}})]
        for _ in range(2):  # warm: every copy of every round once
            for b in bodies:
                port.search("m", copy.deepcopy(b))
        kernels.reset()
        for _ in range(4):
            for b in bodies:
                port.search("m", copy.deepcopy(b))
        snap = kernels.snapshot()
        assert snap.get("executor_data_hit", 0) > 0
        assert not snap.get("executor_data_miss"), snap
        # the LRU holds 32 entries for each copy of a shard
        assert 32 < len(svc.mesh_executor()._data) <= 64
    finally:
        port.close()


def test_stale_group_write_reaches_no_live_copy():
    """The zombie fence on the service: a group object still naming the
    demoted primary raises before any live copy takes its write."""
    port = Node(name="p", device="cpu")
    try:
        svc = _mesh_index(port, replicas=1)
        g = svc.groups[0]
        old_primary, replica = g.primary, g.replicas[0]
        svc.fail_shard(0)
        zombie = ReplicationGroup(0, old_primary, [replica])
        with pytest.raises(port_errors.StalePrimaryException):
            zombie.index("z", {"body": "late"})
        assert not replica.engine.exists("z")
        assert replica.engine.primary_term == 2
        for i in range(6):  # both shards: each write under its own term
            r = svc.index_doc(f"ok{i}", {"body": "river"})
            assert r["_primary_term"] == svc.group_for(f"ok{i}").primary_term
    finally:
        port.close()
