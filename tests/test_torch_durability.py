"""Durability and the index lifecycle of the port against the reference on
the CPU: the gateway restart across packages, the durable flush (ROADMAP
C12), TTL purging, close and open, the recovery registry, the merge's
cancellation and the IVF/PQ blob cache replacing k-means.

A data path one package writes (translog and ``_meta.json``, no flush)
opens in the other with the same hits, totals and versions. The
reference's flush drops its translog with no segment on disk, so its
flushed docs are gone after a restart (pinned here as its own answer);
the port's flush writes a commit first and keeps every acknowledged doc,
also when the process dies between the commit point and the translog's
commit. Hits and totals compare exactly, scores at rtol 1e-5 across the
packages (the tolerance of the host-loop parity tests) and bit for bit
within the port.
"""
import copy
import os
import shutil

import numpy as np
import pytest

from elasticsearch_tpu.cluster import metadata as ref_metadata
from elasticsearch_tpu.index import ivf_cache as ref_cache
from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu.utils.errors import \
    ElasticsearchTpuException as RefError
from elasticsearch_tpu_torch.cluster.metadata import IndexClosedException
from elasticsearch_tpu_torch.index import ivf_cache, snapshots
from elasticsearch_tpu_torch.index.translog import Translog
from elasticsearch_tpu_torch.monitor import kernels
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.tracing import tasks
from elasticsearch_tpu_torch.utils.errors import (IndexAlreadyExistsException,
                                                  TaskCancelledException)

from _torch_parity import MAPPING, clustered, corpus

BODIES = [
    {"query": {"match": {"body": "fox river dog"}}, "size": 20},
    {"query": {"match": {"body": "the quick"}}, "size": 5, "from": 3},
    {"query": {"bool": {"must": [{"match": {"body": "search"}}],
                        "filter": [{"term": {"tag": "t2"}}]}}},
    {"query": {"range": {"n": {"gte": 0}}}, "size": 0},
]
VEC_MAPPING = {"properties": {
    "v": {"type": "dense_vector", "dims": 16,
          "index_options": {"type": "ivf_pq"}},
    "tag": {"type": "keyword"}}}


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    from elasticsearch_tpu.parallel import aot

    monkeypatch.setattr(aot, "_ENABLED", False)
    ivf_cache.reset()
    ref_cache.reset()
    yield
    ivf_cache.reset()
    ref_cache.reset()


def write(node, n=240, shards=2, every=60):
    """The same writes on either package: docs, a refresh every ``every``
    docs, deletes, re-indexed docs (version 2) and a partial update."""
    node.create_index("w", {"settings": {"number_of_shards": shards},
                            "mappings": MAPPING})
    svc = node.indices["w"]
    docs = corpus(n, seed=7)
    for i, (doc_id, src) in enumerate(docs):
        svc.index_doc(doc_id, copy.deepcopy(src))
        if i % every == every - 1:
            svc.refresh()
    for doc_id, _ in docs[::11]:
        svc.delete_doc(doc_id)
    for doc_id, src in docs[5::13]:
        svc.index_doc(doc_id, dict(src, tag="t9"))
    svc.update_doc(docs[2][0], {"doc": {"tag": "t8"}})
    svc.refresh()
    return [doc_id for doc_id, _ in docs]


def answers(node, index="w"):
    return [node.search(index, copy.deepcopy(b)) for b in BODIES]


def versions(node, ids, index="w"):
    svc = node.indices[index]
    out = {}
    for doc_id in ids:
        g = svc.get_doc(doc_id)
        out[doc_id] = (g["_version"], g["_source"]) if g["found"] else None
    return out


def hold(got, want, rtol=1e-5):
    for g, w, b in zip(got, want, BODIES):
        assert g["hits"]["total"] == w["hits"]["total"], b
        assert [h["_id"] for h in g["hits"]["hits"]] == \
            [h["_id"] for h in w["hits"]["hits"]], b
        np.testing.assert_allclose(
            [h["_score"] for h in g["hits"]["hits"]],
            [h["_score"] for h in w["hits"]["hits"]], rtol=rtol,
            err_msg=str(b))


# -- the gateway across packages ------------------------------------------------

def test_a_reference_data_path_opens_in_the_port(tmp_path):
    d, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    ref = RefNode(data_path=d)
    ids = write(ref)
    ref.close()
    shutil.copytree(d, d2)
    port, ref2 = Node(data_path=d, device="cpu"), RefNode(data_path=d2)
    try:
        assert sorted(port.indices) == sorted(ref2.indices) == ["w"]
        hold(answers(port), answers(ref2))
        assert versions(port, ids) == versions(ref2, ids)
        assert port.indices["w"].mappings.to_json() == \
            ref2.indices["w"].mappings.to_json()
    finally:
        port.close()
        ref2.close()


def test_a_port_data_path_opens_in_the_reference(tmp_path):
    d, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    port = Node(data_path=d, device="cpu")
    ids = write(port)
    before = answers(port)
    port.close()
    shutil.copytree(d, d2)
    ref, port2 = RefNode(data_path=d), Node(data_path=d2, device="cpu")
    try:
        hold(answers(ref), answers(port2))
        assert versions(ref, ids) == versions(port2, ids)
        # one refresh of the whole translog: the port answers as before
        # only where the layout was one segment a shard already
        assert [a["hits"]["total"] for a in answers(port2)] == \
            [a["hits"]["total"] for a in before]
    finally:
        ref.close()
        port2.close()


# -- C12: the durable flush ------------------------------------------------------

def _c12(node_cls, d, **kw):
    node = node_cls(data_path=d, **kw)
    node.create_index("i", {"settings": {"number_of_shards": 1}})
    svc = node.indices["i"]
    for i in range(5):
        svc.index_doc(str(i), {"body": f"fox {i}"})
    svc.flush()
    svc.index_doc("5", {"body": "fox 5"})
    node.close()
    node = node_cls(data_path=d, **kw)
    total = node.search("i", {"query": {"match_all": {}}})["hits"]["total"]
    found = [node.indices["i"].get_doc(str(i))["found"] for i in range(6)]
    node.close()
    return total, found


def test_c12_the_reference_loses_flushed_docs_and_the_port_keeps_them(
        tmp_path):
    # the reference's own answer: only the doc after the flush survives
    assert _c12(RefNode, str(tmp_path / "r")) == \
        (1, [False] * 5 + [True])
    assert _c12(Node, str(tmp_path / "p"), device="cpu") == (6, [True] * 6)


def test_flush_restart_keeps_every_acknowledged_doc(tmp_path):
    d = str(tmp_path / "p")
    port = Node(data_path=d, device="cpu")
    ids = write(port, shards=3)
    port.indices["w"].flush()
    # after the flush: more writes, a delete of a committed doc, an update
    svc = port.indices["w"]
    for doc_id, src in corpus(260, seed=7)[240:]:
        svc.index_doc(doc_id, copy.deepcopy(src))
    svc.delete_doc(ids[1])
    svc.update_doc(ids[3], {"doc": {"tag": "t7"}})
    ids += [f"d{i}" for i in range(240, 260)]
    svc.flush()  # a second commit: incremental, the first's blobs dropped
    svc.index_doc("late", {"body": "fox after the last flush", "tag": "t1"})
    svc.refresh()
    want_v = versions(port, ids + ["late"])
    want = answers(port)
    port.close()
    again = Node(data_path=d, device="cpu")
    try:
        assert versions(again, ids + ["late"]) == want_v
        hold(answers(again), want, rtol=0)
        e = again.indices["w"].shards[0].engine
        assert e.num_docs == sum(1 for s in e.segments
                                 for _ in np.nonzero(s.live_host)[0])
        for sh in range(3):
            blobs = os.listdir(os.path.join(d, "w", str(sh), "_commit",
                                            "blobs"))
            commit = again.indices["w"].shards[sh].engine.commit_dir
            assert len(blobs) == len(os.listdir(os.path.join(commit,
                                                             "blobs")))
    finally:
        again.close()


def test_a_crash_between_the_commit_point_and_the_translog_commit(
        tmp_path, monkeypatch):
    """commit.json is down, the translog still holds every op: the replay
    skips the ops at or below the commit's max seq no, so nothing applies
    twice and the versions and seq nos stand."""
    d = str(tmp_path / "p")
    port = Node(data_path=d, device="cpu")
    ids = write(port)
    svc = port.indices["w"]
    monkeypatch.setattr(Translog, "commit", lambda self: None)
    svc.flush()
    monkeypatch.undo()
    for doc_id in ids[20:25]:
        svc.index_doc(doc_id, {"body": "fox again", "tag": "t1"})
    svc.refresh()
    want_v = versions(port, ids)
    seq = [s.engine.max_seq_no for s in svc.shards]
    want = answers(port)
    ops = [sum(1 for _ in s.engine.translog.replay()) for s in svc.shards]
    port.close()
    again = Node(data_path=d, device="cpu")
    try:
        assert versions(again, ids) == want_v
        assert [s.engine.max_seq_no for s in again.indices["w"].shards] \
            == seq
        got = answers(again)
        assert [g["hits"]["total"] for g in got] == \
            [w["hits"]["total"] for w in want]
        entries = again.indices["w"].recoveries.entries()
        live = [s.engine.num_docs for s in again.indices["w"].shards]
        for e, n_ops, n_live in zip(entries, ops, live):
            # committed docs plus the five re-indexed ones; every other
            # translog op was skipped
            assert e["stage"] == "done" and e["ops_replayed"] < n_ops
            assert e["ops_replayed"] >= n_live
    finally:
        again.close()


def test_a_flush_syncs_its_commit_before_the_translog_drops_ops(
        tmp_path, monkeypatch):
    """Every block, the blob directory, commit.json and the commit
    directory are fsynced before the first translog generation goes: an OS
    crash after the flush finds the commit whole."""
    d = str(tmp_path / "p")
    port = Node(data_path=d, device="cpu")
    write(port, shards=1)
    svc = port.indices["w"]
    events = []
    real_fsync, real_remove = os.fsync, os.remove

    def fsync(fd):
        events.append(("fsync", os.readlink(f"/proc/self/fd/{fd}")))
        real_fsync(fd)

    def remove(path, *a, **kw):
        events.append(("remove", os.path.realpath(path)))
        real_remove(path, *a, **kw)

    monkeypatch.setattr(os, "fsync", fsync)
    monkeypatch.setattr(os, "remove", remove)
    monkeypatch.setattr(os, "unlink", remove)
    svc.flush()
    got = list(events)
    try:
        commit_dir = os.path.realpath(svc.shards[0].engine.commit_dir)
        blob_dir = os.path.join(commit_dir, "blobs")
        commit = snapshots.read_commit(commit_dir)
        assert commit["blobs"]
        synced = [p for kind, p in got if kind == "fsync"]
        dropped = [i for i, (kind, p) in enumerate(got) if kind == "remove"
                   and not p.startswith(commit_dir)]
        assert dropped, "the flush dropped no translog generation"
        need = [os.path.join(blob_dir, f"{sha}.json.gz.tmp")
                for sha in commit["blobs"]]
        need += [blob_dir, os.path.join(commit_dir, "commit.json.tmp"),
                 commit_dir]
        at = [got.index(("fsync", p)) for p in need]
        assert max(at) < dropped[0]
        # the commit directory is synced after commit.json took its name
        assert at[-1] > at[-2] and at[-1] > at[-3]
        assert len(synced) >= len(need)
    finally:
        port.close()


def test_a_flush_rewrites_a_block_a_crash_tore(tmp_path):
    """A block a crash left torn under its own name (written, never
    synced, not yet named by a commit) is read back and rewritten by the
    next flush, not kept because its name is there."""
    d = str(tmp_path / "p")
    port = Node(data_path=d, device="cpu")
    ids = write(port, shards=1)
    engine = port.indices["w"].shards[0].engine
    blob_dir = os.path.join(engine.commit_dir, "blobs")
    os.makedirs(blob_dir)
    torn = set()
    for seg in engine.segments:
        sha = snapshots.put_blob(
            blob_dir, snapshots._segment_payload(seg, live_only=False))
        path = os.path.join(blob_dir, f"{sha}.json.gz")
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
        torn.add(sha)
    want_v = versions(port, ids)
    want = answers(port)
    port.indices["w"].flush()
    assert torn <= set(snapshots.read_commit(engine.commit_dir)["blobs"])
    port.close()
    again = Node(data_path=d, device="cpu")
    try:
        assert not again.failed_indices
        assert versions(again, ids) == want_v
        hold(answers(again), want, rtol=0)
    finally:
        again.close()


def test_an_index_that_fails_to_recover_is_reported_and_kept(tmp_path,
                                                            caplog):
    """A torn commit block fails the index's recovery: the node starts,
    logs it, lists it in ``failed_indices``, refuses to create an index
    over its data, and ``delete_index`` drops it."""
    d = str(tmp_path / "p")
    port = Node(data_path=d, device="cpu")
    write(port, shards=2)
    port.indices["w"].flush()
    port.create_index("other", {"settings": {"number_of_shards": 1}})
    port.indices["other"].index_doc("1", {"body": "fox"})
    port.close()
    blob_dir = os.path.join(d, "w", "1", "_commit", "blobs")
    path = os.path.join(blob_dir, sorted(os.listdir(blob_dir))[0])
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    again = Node(data_path=d, device="cpu")
    try:
        assert "w" not in again.indices
        assert set(again.failed_indices) == {"w"}
        assert again.failed_indices["w"]["reason"]
        assert "index [w] failed to recover" in caplog.text
        assert again.indices["other"].get_doc("1")["found"]
        with pytest.raises(IndexAlreadyExistsException):
            again.create_index("w")
        assert os.path.exists(path)
        again.delete_index("w")
        assert not again.failed_indices
        assert not os.path.exists(os.path.join(d, "w"))
        again.create_index("w", {"settings": {"number_of_shards": 1}})
        assert again.search("w", {"query": {"match_all": {}}})[
            "hits"]["total"] == 0
    finally:
        again.close()


# -- TTL ---------------------------------------------------------------------------

TTL_MAPPING = {"_ttl": {"enabled": True, "default": "1d"},
               "_timestamp": {"enabled": True},
               "properties": {"body": {"type": "text"}}}


def _ttl_writes(svc, now):
    for i in range(60):
        # every fifth doc was stamped two days ago: its expiry has passed
        ts = now - 2 * 86_400_000 if i % 5 == 0 else now
        svc.index_doc(f"t{i}", {"body": f"fox {i}"}, timestamp=ts)


def test_ttl_purges_at_refresh_and_survives_a_restart(tmp_path):
    import time

    now = int(time.time() * 1000)
    d = str(tmp_path / "p")
    ref, port = RefNode(name="r"), Node(data_path=d, device="cpu")
    for node in (ref, port):
        node.create_index("t", {"settings": {"number_of_shards": 2},
                                "mappings": TTL_MAPPING})
        _ttl_writes(node.indices["t"], now)
        node.indices["t"].refresh()
    body = {"query": {"match_all": {}}, "size": 100}
    got = port.search("t", copy.deepcopy(body))
    want = ref.search("t", copy.deepcopy(body))
    assert got["hits"]["total"] == want["hits"]["total"] == 48
    assert sorted(h["_id"] for h in got["hits"]["hits"]) == \
        sorted(h["_id"] for h in want["hits"]["hits"])
    assert sum(s.engine.stats.delete_total
               for s in port.indices["t"].shards) == 12
    port.close()
    ref.close()
    again = Node(data_path=d, device="cpu")
    try:
        assert again.search("t", body)["hits"]["total"] == 48
        loc = again.indices["t"].find_doc_location("t1")
        assert loc.ttl_expiry == loc.timestamp + 86_400_000
    finally:
        again.close()


def test_ttl_purges_in_a_merge(tmp_path):
    import time

    port = Node(device="cpu")
    port.create_index("t", {"mappings": TTL_MAPPING})
    svc = port.indices["t"]
    now = int(time.time() * 1000)
    for i in range(10):
        svc.index_doc(f"a{i}", {"body": "fox"})
        svc.refresh()
    # an expiry that passes after the refresh: the force merge purges it
    svc.index_doc("soon", {"body": "fox"}, timestamp=now - 86_400_000 + 300)
    svc.refresh()
    time.sleep(0.5)
    svc.force_merge(1)
    assert not svc.get_doc("soon")["found"]
    assert svc.search({"query": {"match_all": {}}})["hits"]["total"] == 10
    port.close()


# -- close and open ------------------------------------------------------------------

def test_close_and_open_against_the_reference(tmp_path):
    d = str(tmp_path / "p")
    ref, port = RefNode(name="r"), Node(data_path=d, device="cpu")
    for node in (ref, port):
        for name in ("a", "b"):
            node.create_index(name, {"mappings": MAPPING})
            node.indices[name].index_doc("1", {"body": "fox", "tag": "t1"})
            node.indices[name].refresh()
    ref_metadata.close_index(ref, "a")
    port.close_index("a")
    body = {"query": {"match": {"body": "fox"}}}
    for node, exc in ((ref, RefError), (port, IndexClosedException)):
        with pytest.raises(exc) as e:
            node.search("a", copy.deepcopy(body))
        assert e.value.status == 403 and "closed index [a]" in str(e.value)
        with pytest.raises(exc):
            node.indices["a"].index_doc("2", {"body": "x"})
        # a wildcard skips the closed index
        r = node.search("*", copy.deepcopy(body))
        assert r["hits"]["total"] == 1 and r["_shards"]["total"] == 1
    port.close()
    again = Node(data_path=d, device="cpu")
    try:
        assert again.indices["a"].closed
        assert again.cluster_state.indices["a"].state == "close"
        again.open_index("a")
        assert again.search("a", body)["hits"]["total"] == 1
        again.indices["a"].index_doc("2", {"body": "fox"})
    finally:
        again.close()
    ref2 = RefNode(data_path=d)  # the reference reads the port's meta
    try:
        assert not ref2.indices["a"].closed
    finally:
        ref2.close()


# -- the recovery registry ---------------------------------------------------------

def test_recovery_entries_match_the_reference(tmp_path):
    d, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    ref, port = RefNode(data_path=d), Node(data_path=d2, device="cpu")
    for node in (ref, port):
        write(node, shards=3)
        node.close()
    ref, port = RefNode(data_path=d), Node(data_path=d2, device="cpu")
    try:
        keys = ("shard", "type", "stage", "ops_replayed", "docs_copied")
        got = [tuple(e[k] for k in keys)
               for e in port.indices["w"].recoveries.entries()]
        want = [tuple(e[k] for k in keys)
                for e in ref.indices["w"].recoveries.entries()]
        assert got == want and len(got) == 3
        assert got[0][3] > 0
        rec = port.indices["w"].stats()["recovery"]
        assert rec["total"] == 3 and rec["ops_replayed"] == \
            sum(g[3] for g in got)
    finally:
        ref.close()
        port.close()


# -- the merge's cancellation ----------------------------------------------------

def test_a_cancelled_force_merge_changes_nothing():
    port = Node(device="cpu")
    port.create_index("m", {"mappings": MAPPING})
    svc = port.indices["m"]
    for i, (doc_id, src) in enumerate(corpus(60, seed=3)):
        svc.index_doc(doc_id, src)
        if i % 20 == 19:
            svc.refresh()
    before = [s.seg_id for s in svc.shards[0].segments]
    assert len(before) == 3
    want = answers(port, "m")
    task = tasks.Task(1, "n", "indices:admin/optimize")
    task.cancel()
    token = tasks.set_current(task)
    try:
        with pytest.raises(TaskCancelledException):
            svc.force_merge(1)
    finally:
        tasks.reset_current(token)
    assert [s.seg_id for s in svc.shards[0].segments] == before
    hold(answers(port, "m"), want, rtol=0)
    svc.force_merge(1)
    assert len(svc.shards[0].segments) == 1
    port.close()


# -- the blob cache replaces k-means -------------------------------------------------

def _vec_writes(svc, n=600):
    vecs = clustered(n, 16, 6, seed=11)
    for i, v in enumerate(vecs):
        svc.index_doc(str(i), {"v": [float(x) for x in v],
                               "tag": f"t{i % 3}"})
    svc.refresh()
    return vecs


def _knn_bodies(vecs):
    q = [float(x) for x in vecs[7] + 0.1]
    knn = {"field": "v", "query_vector": q}
    return [{"query": {"knn": dict(knn, num_candidates=60)}},
            {"query": {"knn": dict(knn, num_candidates=120, k=20)},
             "size": 20},
            {"query": {"knn": dict(knn, ann=False)}}]


def _knn_hits(node, bodies):
    return [[(h["_id"], h["_score"]) for h in node.search(
        "v", copy.deepcopy(b))["hits"]["hits"]] for b in bodies]


def test_a_restart_loads_the_quantizer_instead_of_k_means(tmp_path):
    d = str(tmp_path / "p")
    kernels.reset()
    port = Node(data_path=d, device="cpu")
    port.create_index("v", {"mappings": VEC_MAPPING})
    vecs = _vec_writes(port.indices["v"])
    bodies = _knn_bodies(vecs)
    want = _knn_hits(port, bodies)
    snap = kernels.snapshot()
    assert snap.get("ivf_build") == 1 and snap.get("pq_build") == 1
    # beside the quantizer's blobs the tier may hold the kernel
    # libraries the process loaded (parallel/aot.py), never more
    exts = [f.rsplit(".", 1)[1] for f in os.listdir(os.path.join(d, "_ivf"))]
    assert sorted(e for e in exts if e != "kso") == ["ivf", "pq"]
    port.close()
    ivf_cache.reset()  # a new process: the memory layer is empty
    kernels.reset()
    again = Node(data_path=d, device="cpu")
    try:
        snap = kernels.snapshot()
        assert snap.get("ivf_cache_hit") == 1 and snap.get("pq_cache_hit") \
            == 1
        assert "ivf_build" not in snap and "pq_build" not in snap
        assert _knn_hits(again, bodies) == want
    finally:
        again.close()
    # no _ivf directory: the restart builds again, and answers the same
    shutil.rmtree(os.path.join(d, "_ivf"))
    ivf_cache.reset()
    kernels.reset()
    cold = Node(data_path=d, device="cpu")
    try:
        assert kernels.snapshot().get("ivf_build") == 1
        assert _knn_hits(cold, bodies) == want
    finally:
        cold.close()


def test_a_node_stores_its_blobs_in_its_own_data_path(tmp_path):
    """Two Nodes in one process: the quantizer one builds lands in its
    own ``_ivf`` only, and the other still loads it (loads read every
    registered directory)."""
    da, db = str(tmp_path / "a"), str(tmp_path / "b")
    a, b = Node(data_path=da, device="cpu"), Node(data_path=db, device="cpu")
    try:
        a.create_index("v", {"mappings": VEC_MAPPING})
        vecs = _vec_writes(a.indices["v"])
        bodies = _knn_bodies(vecs)
        want = _knn_hits(a, bodies)
        assert sorted(f.rsplit(".", 1)[1]
                      for f in os.listdir(os.path.join(da, "_ivf"))) == \
            ["ivf", "pq"]
        assert not os.path.exists(os.path.join(db, "_ivf"))
        ivf_cache._MEM.clear()
        kernels.reset()
        b.create_index("v", {"mappings": VEC_MAPPING})
        _vec_writes(b.indices["v"])
        assert _knn_hits(b, bodies) == want
        snap = kernels.snapshot()
        assert snap.get("ivf_cache_hit") == 1 and "ivf_build" not in snap
        assert not os.path.exists(os.path.join(db, "_ivf"))
    finally:
        a.close()
        b.close()


def test_a_blob_the_reference_wrote_serves_the_port(tmp_path):
    """The reference builds and stores the quantizer; the port opens the
    same data path, loads the blob (no k-means) and its IVF-PQ hits equal
    the reference's over the same blob."""
    d, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    ref = RefNode(data_path=d)
    ref.create_index("v", {"mappings": VEC_MAPPING})
    vecs = _vec_writes(ref.indices["v"])
    ref.close()
    shutil.copytree(d, d2)
    ivf_cache.reset()
    ref_cache.reset()
    kernels.reset()
    port, ref2 = Node(data_path=d, device="cpu"), RefNode(data_path=d2)
    try:
        snap = kernels.snapshot()
        assert snap.get("ivf_cache_hit") == 1 and snap.get("pq_cache_hit") \
            == 1 and "ivf_build" not in snap
        bodies = _knn_bodies(vecs)
        got, want = _knn_hits(port, bodies), _knn_hits(ref2, bodies)
        for g, w in zip(got, want):
            assert [i for i, _ in g] == [i for i, _ in w]
            np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                                       rtol=1e-5)
    finally:
        port.close()
        ref2.close()


# -- the ops stream and a damaged translog ----------------------------------------

def test_apply_translog_op_matches_the_reference():
    ops = [{"op": "index", "id": "a", "source": {"body": "fox"},
            "version": 3, "seq_no": 0, "term": 1},
           {"op": "index", "id": "a", "source": {"body": "old"},
            "version": 2, "seq_no": 1, "term": 1},
           {"op": "index", "id": "a", "source": {"body": "same"},
            "version": 3, "seq_no": 2, "term": 1},
           {"op": "delete", "id": "b", "version": 1, "seq_no": 3,
            "term": 1},
           {"op": "delete", "id": "a", "version": 4, "seq_no": 4,
            "term": 1},
           {"op": "index", "id": "c", "source": {"body": "dog"},
            "version": 7, "seq_no": 5, "term": 2}]
    ref, port = RefNode(name="r"), Node(name="p", device="cpu")
    try:
        out = []
        for node in (ref, port):
            node.create_index("o", {"mappings": MAPPING})
            engine = node.indices["o"].shards[0].engine
            got = []
            for op in ops:
                try:
                    engine.apply_translog_op(copy.deepcopy(op))
                    got.append("ok")
                except (RefError, Exception) as e:
                    got.append(type(e).__name__)
            got += [engine.get(d) and (engine.get(d)["_version"],
                                       engine.get(d)["_source"])
                    for d in "abc"]
            got.append((engine.max_seq_no, engine.primary_term))
            out.append(got)
        assert out[0] == out[1]
        assert out[1][:6] == ["ok", "VersionConflictException", "ok",
                              "DocumentMissingException", "ok", "ok"]
    finally:
        ref.close()
        port.close()


def test_a_corrupt_translog_tail_is_counted_and_cut(tmp_path):
    from elasticsearch_tpu.monitor.stats import TRANSLOG_RECOVERY as REF_TR
    from elasticsearch_tpu_torch.monitor.stats import TRANSLOG_RECOVERY

    d, d2 = str(tmp_path / "p"), str(tmp_path / "r")
    port = Node(data_path=d, device="cpu")
    port.create_index("c", {"mappings": MAPPING})
    for i in range(5):
        port.indices["c"].index_doc(str(i), {"body": f"fox {i}"})
    port.close()
    with open(os.path.join(d, "c", "0", "translog.1"), "ab") as f:
        f.write(b"\xe5\x02\x00\x00\x01\x00torn")
    shutil.copytree(d, d2)
    TRANSLOG_RECOVERY.reset()
    REF_TR.reset()
    port, ref = Node(data_path=d, device="cpu"), RefNode(data_path=d2)
    try:
        for node in (port, ref):
            assert node.search("c", {"query": {"match_all": {}}})[
                "hits"]["total"] == 5
        got, want = TRANSLOG_RECOVERY.to_json(), REF_TR.to_json()
        assert got["corrupt_tail_frames_skipped"] == \
            want["corrupt_tail_frames_skipped"] == 1
        assert got["corrupt_tail_bytes_dropped"] == \
            want["corrupt_tail_bytes_dropped"] == 10
        assert got["events"][0]["reason"] == want["events"][0]["reason"]
    finally:
        port.close()
        ref.close()
