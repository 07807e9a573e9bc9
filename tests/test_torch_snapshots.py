"""Snapshot and restore (``index/snapshots.py``) of the port against the
reference on the CPU.

The same writes go to both packages' nodes; their snapshots must name the
same content-addressed blobs (the doc blocks are byte-identical JSON),
write only the changed blocks the second time, report the same
responses and ``snapshot_info``, collect the same blobs when a snapshot
is deleted, and restore to the same hits, totals and versions. A
repository either package wrote restores in the other. A restored
``ivf_pq`` segment loads its quantizer and PQ tier from the seeded blobs
instead of running k-means. Hits and totals compare exactly, scores at
rtol 1e-5.
"""
import copy
import os

import numpy as np
import pytest

from elasticsearch_tpu.index import ivf_cache as ref_cache
from elasticsearch_tpu.index import snapshots as ref_snap
from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu.utils.errors import \
    ElasticsearchTpuException as RefError
from elasticsearch_tpu_torch.index import ivf_cache
from elasticsearch_tpu_torch.index import snapshots as port_snap
from elasticsearch_tpu_torch.monitor import kernels
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.utils.errors import ElasticsearchTpuException

from _torch_parity import MAPPING, clustered, corpus

BODIES = [
    {"query": {"match": {"body": "fox river dog"}}, "size": 20},
    {"query": {"bool": {"must": [{"match": {"body": "search engine"}}],
                        "filter": [{"term": {"tag": "t3"}}]}}},
    {"query": {"match_all": {}}, "size": 0},
]
VEC_MAPPING = {"properties": {
    "v": {"type": "dense_vector", "dims": 16,
          "index_options": {"type": "ivf_pq"}}}}


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    from elasticsearch_tpu.parallel import aot

    monkeypatch.setattr(aot, "_ENABLED", False)
    ivf_cache.reset()
    ref_cache.reset()
    yield
    ivf_cache.reset()
    ref_cache.reset()


def _pkg(node):
    return port_snap if isinstance(node, Node) else ref_snap


def _write(node, lo=0, hi=200, every=50):
    if "s" not in node.indices:
        node.create_index("s", {"settings": {"number_of_shards": 2},
                                "mappings": MAPPING,
                                "aliases": {"logs": {}}})
    svc = node.indices["s"]
    docs = corpus(hi, seed=12)[lo:]
    for i, (doc_id, src) in enumerate(docs):
        svc.index_doc(doc_id, copy.deepcopy(src))
        if i % every == every - 1:
            svc.refresh()
    svc.refresh()
    return [d for d, _ in docs]


def _hold(got, want):
    assert got["hits"]["total"] == want["hits"]["total"]
    assert [h["_id"] for h in got["hits"]["hits"]] == \
        [h["_id"] for h in want["hits"]["hits"]]
    np.testing.assert_allclose([h["_score"] for h in got["hits"]["hits"]],
                               [h["_score"] for h in want["hits"]["hits"]],
                               rtol=1e-5)


def _answers(node, index):
    return [node.search(index, copy.deepcopy(b)) for b in BODIES]


def _blobs(loc):
    return sorted(os.listdir(os.path.join(loc, "blobs")))


def test_create_incremental_delete_and_info_match_the_reference(tmp_path):
    ref, port = RefNode(name="r"), Node(name="p", device="cpu")
    out = {}
    try:
        for node, tag in ((ref, "ref"), (port, "port")):
            snap = _pkg(node)
            loc = str(tmp_path / tag)
            repo = snap.FsRepository("backup", loc)
            node.put_template("t", {"template": "s*", "order": 1,
                                    "settings": {"number_of_shards": 2}})
            _write(node)
            r1 = snap.create_snapshot(node, repo, "s1")
            b1 = _blobs(loc)
            # 1% more writes: only the shards' new blocks are written
            _write(node, 200, 202, every=1000)
            node.indices["s"].delete_doc("d3")
            r2 = snap.create_snapshot(node, repo, "s2")
            b2 = _blobs(loc)
            with pytest.raises((RefError, ElasticsearchTpuException)) as e:
                snap.create_snapshot(node, repo, "s1")
            dup = (type(e.value).__name__, str(e.value))
            info = snap.snapshot_info(repo, "s2")
            m2 = repo.get_manifest("s2")
            repo.delete_snapshot("s1")
            out[tag] = dict(r1=r1, r2=r2, b1=b1, b2=b2, b3=_blobs(loc),
                            dup=dup, info={k: v for k, v in info.items()
                                           if "time" not in k},
                            shards=[s["blobs"] for s in
                                    m2["indices"]["s"]["shards"]],
                            versions=[s["versions"] for s in
                                      m2["indices"]["s"]["shards"]],
                            gs=m2["global_state"]["templates"],
                            aliases=m2["indices"]["s"]["aliases"])
            with pytest.raises((RefError, ElasticsearchTpuException)) as e:
                snap.snapshot_info(repo, "s1")
            assert e.value.status == 404
    finally:
        ref.close()
        port.close()
    assert out["port"] == out["ref"]
    p = out["port"]
    # the incremental snapshot wrote new blocks only; the delete kept them
    assert set(p["b1"]) < set(p["b2"])
    assert len(p["b2"]) - len(p["b1"]) <= 4
    assert {f.split(".", 1)[0] for f in p["b3"]} == \
        {b for sh in p["shards"] for b in sh}


@pytest.mark.parametrize("writer, reader", [("ref", "port"),
                                            ("port", "ref"),
                                            ("port", "port")])
def test_a_repository_restores_in_either_package(tmp_path, writer, reader):
    nodes = {"ref": RefNode(name="r"), "port": Node(name="p", device="cpu")}
    src = nodes[writer]
    try:
        ids = _write(src)
        src.indices["s"].delete_doc(ids[4])
        src.indices["s"].index_doc(ids[5], {"body": "fox fox", "tag": "t3"})
        loc = str(tmp_path / "repo")
        _pkg(src).create_snapshot(src, _pkg(src).FsRepository("b", loc),
                                  "snap")
        # the reader and, as the oracle, the reference restore the same
        # repository into fresh nodes under a new name
        got_node = RefNode(name="g") if reader == "ref" \
            else Node(name="g", device="cpu")
        want_node = RefNode(name="w")
        try:
            for node in (got_node, want_node):
                snap = _pkg(node)
                r = snap.restore_snapshot(
                    node, snap.FsRepository("b", loc), "snap",
                    rename_pattern="s", rename_replacement="restored")
                assert r["snapshot"]["indices"] == ["restored"]
                assert r["snapshot"]["shards"] == {
                    "total": 2, "failed": 0, "successful": 2}
            for g, w, s in zip(_answers(got_node, "restored"),
                               _answers(want_node, "restored"),
                               _answers(src, "s")):
                _hold(g, w)
                assert g["hits"]["total"] == s["hits"]["total"]
            for doc_id in ids[:12]:
                g = got_node.indices["restored"].get_doc(doc_id)
                w = src.indices["s"].get_doc(doc_id)
                assert g["found"] == w["found"]
                if w["found"]:
                    assert (g["_version"], g["_source"]) == \
                        (w["_version"], w["_source"])
            assert "logs" in got_node.indices["restored"].aliases
            # a second restore onto the same name is refused up front
            with pytest.raises((RefError, ElasticsearchTpuException)) as e:
                _pkg(got_node).restore_snapshot(
                    got_node, _pkg(got_node).FsRepository("b", loc), "snap",
                    rename_pattern="s", rename_replacement="restored")
            assert "already exists" in str(e.value)
        finally:
            got_node.close()
            want_node.close()
    finally:
        for n in nodes.values():
            n.close()


def test_a_full_restore_brings_back_the_templates(tmp_path):
    port = Node(name="p", device="cpu")
    port.put_template("logs", {"template": "logs-*", "order": 2,
                               "mappings": MAPPING})
    _write(port)
    loc = str(tmp_path / "repo")
    repo = port_snap.FsRepository("b", loc)
    port_snap.create_snapshot(port, repo, "snap")
    fresh = Node(name="f", device="cpu")
    try:
        port_snap.restore_snapshot(fresh, repo, "snap", indices=["s"])
        assert "logs" not in fresh.cluster_state.templates  # index-scoped
        fresh.delete_index("s")
        port_snap.restore_snapshot(fresh, repo, "snap")
        assert fresh.cluster_state.templates["logs"]["order"] == 2
    finally:
        fresh.close()
        port.close()


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_a_restore_seeds_the_quantizer_blobs(tmp_path, writer):
    src = RefNode(name="r") if writer == "ref" \
        else Node(name="p", device="cpu")
    vecs = clustered(600, 16, 6, seed=21)
    src.create_index("v", {"mappings": VEC_MAPPING})
    for i, v in enumerate(vecs):
        src.indices["v"].index_doc(str(i), {"v": [float(x) for x in v]})
    src.indices["v"].refresh()
    q = [float(x) for x in vecs[3] + 0.05]
    body = {"query": {"knn": {"field": "v", "query_vector": q,
                              "num_candidates": 80}}, "size": 10}
    want = src.search("v", copy.deepcopy(body))
    loc = str(tmp_path / "repo")
    _pkg(src).create_snapshot(src, _pkg(src).FsRepository("b", loc), "snap")
    src.close()
    ivf_cache.reset()
    ref_cache.reset()
    kernels.reset()
    fresh = Node(name="f", device="cpu")
    try:
        port_snap.restore_snapshot(fresh, port_snap.FsRepository("b", loc),
                                   "snap")
        snap = kernels.snapshot()
        assert snap.get("ivf_cache_hit") == 1 and snap.get("pq_cache_hit") \
            == 1
        assert "ivf_build" not in snap and "pq_build" not in snap
        got = fresh.search("v", copy.deepcopy(body))
        _hold(got, want)
    finally:
        fresh.close()


def test_a_restore_keeps_each_docs_ttl_expiry(tmp_path):
    """The port's restore carries each doc's resolved ``_timestamp`` and
    ``_ttl`` expiry; the reference's re-resolves them at the restore, so
    a doc written twelve hours ago comes back with a full day to live."""
    import time

    mapping = {"_ttl": {"enabled": True, "default": "1d"},
               "_timestamp": {"enabled": True},
               "properties": {"body": {"type": "text"}}}
    ts = int(time.time() * 1000) - 12 * 3_600_000
    loc = str(tmp_path / "repo")
    port = Node(name="p", device="cpu")
    port.create_index("t", {"mappings": mapping})
    port.indices["t"].index_doc("1", {"body": "fox"}, timestamp=ts)
    port_snap.create_snapshot(port, port_snap.FsRepository("b", loc), "s")
    port.close()
    got_node, ref = Node(name="g", device="cpu"), RefNode(name="r")
    try:
        for node in (got_node, ref):
            _pkg(node).restore_snapshot(node, _pkg(node).FsRepository(
                "b", loc), "s")
        got = got_node.indices["t"].find_doc_location("1")
        want = ref.indices["t"].find_doc_location("1")
        assert (got.timestamp, got.ttl_expiry) == (ts, ts + 86_400_000)
        assert want.ttl_expiry > ts + 86_400_000 + 11 * 3_600_000
    finally:
        got_node.close()
        ref.close()
