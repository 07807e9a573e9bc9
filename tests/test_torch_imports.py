"""The PyTorch port stands alone: it imports neither jax nor the JAX
package (a phrase, a term expansion, a query_string, a function_score on
the mesh, a script_score with script_fields, a span_near, script
aggregations, nested queries and aggs, has_child, the geo queries and
the ``_geo_distance`` sort, the suggesters, the percolator, updates,
bulk, by-query, a flush and restart, a snapshot and restore and the
``stats`` key included, replicas with a failover and a scale, and the
REST server answering a ``_bulk`` and a ``_search`` over HTTP, with the
launcher, the client and the REST module imported), and its entry point
never falls back to the CPU on its own."""
import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import sys
from elasticsearch_tpu_torch import Node
n = Node(device="cpu")
n.create_index("i", {"mappings": {"properties": {
    "body": {"type": "text", "analyzer": "english"}}}})
for i in range(200):
    n.index("i", str(i), {"body": "quick brown fox" if i % 2 else "lazy dog"})
n.refresh()
r = n.search("i", {"query": {"match": {"body": "fox"}}})
assert r["hits"]["total"] == 100, r["hits"]["total"]
q = {"query": {"match": {"body": "fox"}}, "size": 3,
     "highlight": {"fields": {"body": {}}}}
r = n.search("i", dict(q, sort=[{"_score": "asc"}], profile=True))
assert r["profile"]["shards"][0]["tpu"]["segments"] == 1
r = n.search("i", dict(q, scroll="1m"))
from elasticsearch_tpu_torch.search.service import clear_scroll, scroll_next
assert scroll_next(r["_scroll_id"])["hits"]["hits"][0]["highlight"]
assert clear_scroll(r["_scroll_id"])
from elasticsearch_tpu_torch.monitor import kernels
n.create_index("m", {"settings": {"number_of_shards": 3}})
for i in range(90):
    n.index("m", str(i), {"body": "quick fox" if i % 3 else "dog"})
n.refresh("m")
assert n.search("m", {"query": {"match": {"body": "fox"}}})["hits"]["total"] == 60
assert kernels.snapshot().get("mesh_search") == 2, kernels.snapshot()
n.create_index("v", {"mappings": {"properties": {"v": {
    "type": "dense_vector", "dims": 8, "index_options": {"type": "ivf_pq"}}}}})
for i in range(300):
    n.index("v", str(i), {"v": [float((i * j) % 7) for j in range(1, 9)]})
n.refresh("v")
knn = {"field": "v", "query_vector": [1.0] * 8}
for body in (knn, dict(knn, ann=False), dict(knn, query_vector=[[1.0] * 8] * 2)):
    assert n.search("v", {"query": {"knn": body}})["hits"]["hits"]
n.create_index("h", {"mappings": {"properties": {"body": {"type": "text"},
    "v": {"type": "dense_vector", "dims": 8, "index_options": {"type": "ivf_pq"}}}}})
for i in range(300):
    n.index("h", str(i), {"body": "fox" if i % 3 else "dog",
                          "v": [float((i * j) % 5) for j in range(1, 9)]})
n.refresh("h")
hyb = {"query": {"match": {"body": "fox"}}, "knn": dict(knn, ann=False),
       "rerank": {"query_vectors": [[1.0] * 8, [0.5] * 8], "pq": True}}
r = n.search("h", {"query": {"hybrid": hyb}})
assert r["hybrid"]["rerank"] == "applied", r.get("hybrid")
r = n.search("h", {"query": {"match": {"body": "fox"}}, "rescore": {
    "query": {"rescore_query": {"knn": {"field": "v", "query_vectors": [[1.0] * 8]}}}}})
assert r["hits"]["hits"]
r = n.msearch([({"index": "m"}, {"query": {"match": {"body": q}}})
               for q in ("fox", "dog")])
assert [x["hits"]["total"] for x in r["responses"]] == [60, 30], r
assert kernels.snapshot().get("mesh_msearch") == 1, kernels.snapshot()
import threading
n.serving.apply_cluster_settings({"serving.coalescer.mode": "always",
                                  "serving.coalescer.max_wait": "200ms",
                                  "serving.coalescer.idle_gap": "50ms"})
out = []
ts = [threading.Thread(target=lambda q=q: out.append(n.search(
    "i", {"query": {"match": {"body": q}}})["hits"]["total"]))
      for q in ("fox", "dog")]
for t in ts:
    t.start()
for t in ts:
    t.join(60)
assert out == [100, 100], out
assert n.serving.coalescer.stats()["flushes"], n.serving.stats()
n.serving.apply_cluster_settings({})
n.create_index("w", {"settings": {"number_of_shards": 2,
                                  "cache.query.enable": True}})
for i in range(160):
    n.index("w", str(i), {"body": "fox" if i % 4 else "dog river", "tag": i % 3})
    if i % 10 == 9:
        n.refresh("w")
assert "elasticsearch_tpu_torch.index.merge" in sys.modules
svc = n.indices["w"]
assert all(s.engine.stats.merge_total >= 1 for s in svc.shards)
svc.force_merge(1)
assert [len(s.segments) for s in svc.shards] == [1, 1]
q = {"query": {"match": {"body": {"query": "fox", "_name": "f"}}},
     "fields": ["tag"], "search_type": "dfs_query_then_fetch"}
r = n.search("w,i", q)
assert r["hits"]["total"] == 220 and r["hits"]["hits"][0]["matched_queries"] == ["f"]
r = n.search("w", {"size": 0, "aggs": {"t": {"terms": {"field": "tag"}}}})
assert n.search("w", {"size": 0, "aggs": {"t": {"terms": {"field": "tag"}}}}) == r
assert svc.query_cache_stats == {"hits": 1, "misses": 1, "evictions": 0}
assert n.search("*", {"indices_boost": {"w": 2}})["hits"]["total"] == 1050
r = n.search("i", {"query": {"match_phrase": {"body": "quick brown"}},
                   "highlight": {"fields": {"body": {}}}})
assert r["hits"]["total"] == 100 and r["hits"]["hits"][0]["highlight"]
assert kernels.snapshot().get("phrase_program"), kernels.snapshot()
assert n.search("m", {"query": {"wildcard": {"body": "f*x"}}})["hits"]["total"] == 60
r = n.search("i", {"query": {"query_string": {
    "query": '"brown fox" AND qu*', "default_field": "body"}}})
assert r["hits"]["total"] == 100, r["hits"]["total"]
n.create_index("s", {"settings": {"number_of_shards": 2}, "mappings": {
    "properties": {"body": {"type": "text"}, "pop": {"type": "long"}}}})
for i in range(60):
    n.index("s", str(i), {"body": "quick brown fox" if i % 2 else "lazy dog",
                          "pop": i})
n.refresh("s")
kernels.reset()
fs = {"function_score": {"query": {"match": {"body": "fox"}},
                         "field_value_factor": {"field": "pop",
                                                "modifier": "log2p"}}}
assert n.search("s", {"query": fs})["hits"]["total"] == 30
assert kernels.snapshot().get("mesh_search") == 1, kernels.snapshot()
r = n.search("s", {"query": {"function_score": {"script_score": {
    "script": "Math.log10(doc['pop'].value + 2)"}}}, "script_fields": {
    "x": {"script": "doc['pop'].value * 2"}}})
assert r["hits"]["hits"][0]["_id"] == "59" and \
    r["hits"]["hits"][0]["fields"]["x"] == [118.0], r["hits"]["hits"][0]
r = n.search("s", {"query": {"span_near": {"clauses": [
    {"span_term": {"body": "quick"}}, {"span_term": {"body": "fox"}}],
    "slop": 1}}})
assert r["hits"]["total"] == 30 and kernels.snapshot().get("span_device")
r = n.search("s", {"size": 0, "aggs": {
    "a": {"avg": {"script": "doc['pop'].value * 2"}},
    "m": {"scripted_metric": {"map_script": "doc['pop'].value"}}}})
assert r["aggregations"] == {"a": {"value": 59.0},
                             "m": {"value": 1770.0}}, r["aggregations"]
n.create_index("j", {"mappings": {"properties": {
    "c": {"type": "nested", "properties": {"who": {"type": "keyword"}}},
    "loc": {"type": "geo_point"}, "area": {"type": "geo_shape"}}}})
for i in range(20):
    n.index("j", str(i), {"c": [{"who": "a"}, {"who": "b" if i % 2 else "a"}],
                          "loc": {"lat": i, "lon": -i},
                          "area": {"type": "point", "coordinates": [i, 0]}})
n.refresh("j")
r = n.search("j", {"query": {"nested": {"path": "c", "score_mode": "sum",
    "query": {"term": {"c.who": "a"}}, "inner_hits": {}}}})
assert r["hits"]["total"] == 20 and r["hits"]["hits"][0]["inner_hits"]
r = n.search("j", {"query": {"geo_distance": {"distance": "600km",
    "loc": {"lat": 0, "lon": 0}}}, "sort": [{"_geo_distance": {
    "loc": [0, 0]}}], "aggs": {"g": {"geohash_grid": {"field": "loc"}},
    "n": {"nested": {"path": "c"}}}})
assert r["hits"]["total"] == 4 and r["aggregations"]["n"]["doc_count"] == 8
r = n.search("j", {"query": {"geo_shape": {"area": {"shape": {
    "type": "envelope", "coordinates": [[-1, 1], [2.5, -1]]}}}}})
assert r["hits"]["total"] == 3, r["hits"]["total"]
n.create_index("pc", {"mappings": {"q": {}, "a": {"_parent": {"type": "q"}}}})
n.index("pc", "q1", {"t": "x"}, doc_type="q")
n.index("pc", "a1", {"t": "y"}, doc_type="a", parent="q1", routing="q1")
n.refresh("pc")
r = n.search("pc", {"query": {"has_child": {"type": "a",
                                            "query": {"match_all": {}}}}})
assert [h["_id"] for h in r["hits"]["hits"]] == ["q1"], r
n.create_index("sg", {"mappings": {"properties": {"body": {"type": "text"},
    "c": {"type": "completion", "context": {"k": {"type": "category"}}}}}})
for i in range(40):
    n.index("sg", str(i), {"body": "quick brown fox" if i % 2 else "lazy dog",
                           "c": {"input": ["quick", "quiet"], "weight": i,
                                 "context": {"k": "a"}}})
n.refresh("sg")
r = n.search("sg", {"query": {"match": {"body": "fox"}}, "suggest": {
    "t": {"text": "quikc", "term": {"field": "body"}},
    "p": {"text": "quikc brown", "phrase": {"field": "body"}},
    "c": {"text": "qu", "completion": {"field": "c", "context": {"k": "a"}}}}})
assert r["suggest"]["t"][0]["options"][0]["text"] == "quick", r["suggest"]
assert r["suggest"]["p"][0]["options"][0]["text"] == "quick brown", r["suggest"]
assert r["suggest"]["c"][0]["options"][0]["score"] == 39.0, r["suggest"]
svc = n.indices["sg"]
svc.index_doc("alert", {"query": {"match": {"body": "fox"}}},
              doc_type=".percolator")
assert svc.percolate({"doc": {"body": "a fox"}})["total"] == 1
svc.update_doc("1", {"script": "ctx._source.n = 2"})
assert svc.mget(["1"])["docs"][0]["_source"]["n"] == 2
r = n.bulk([{"index": {"_index": "sg", "_id": "x"}}, {"body": "fox"},
            {"update": {"_index": "sg", "_id": "nope"}}, {"doc": {}}])
assert r["errors"] and r["items"][0]["index"]["status"] == 201, r
from elasticsearch_tpu_torch.search.byquery import run_by_query
svc.refresh()
done = run_by_query(svc, {"match": {"body": "dog"}},
                    lambda i, loc: svc.delete_doc(i, routing=loc.routing))
assert len(done) == 20 and svc.count({})["count"] == 22, svc.count({})
n.close()
import os, tempfile
from elasticsearch_tpu_torch.index import snapshots
d = tempfile.mkdtemp()
n = Node(device="cpu", data_path=os.path.join(d, "data"))
n.create_index("d", {"settings": {"number_of_shards": 2}})
for i in range(5):
    n.index("d", str(i), {"body": "fox"})
n.flush("d")
n.index("d", "5", {"body": "fox"})
n.close()
n = Node(device="cpu", data_path=os.path.join(d, "data"))
assert n.search("d", {"query": {"match": {"body": "fox"}}})["hits"]["total"] == 6
repo = snapshots.FsRepository("b", os.path.join(d, "repo"))
snapshots.create_snapshot(n, repo, "s")
n.delete_index("d")
snapshots.restore_snapshot(n, repo, "s")
assert n.search("d", {"stats": ["g"]})["hits"]["total"] == 6
assert n.indices["d"].stats()["primaries"]["search"]["groups"]["g"]["query_total"] == 2
n.create_index("rp", {"settings": {"number_of_shards": 2,
                                   "number_of_replicas": 1}})
for i in range(40):
    assert n.index("rp", str(i), {"body": "fox"})["_shards"]["total"] == 2
n.refresh("rp")
for pref in ("_primary", "_replica", None):
    assert n.search("rp", {"query": {"match": {"body": "fox"}}},
                    preference=pref)["hits"]["total"] == 40
n.indices["rp"].fail_shard(0)
n.update_index_settings("rp", {"number_of_replicas": 2})
assert n.search("rp", {"size": 0}, preference="_replica")["hits"]["total"] == 40
n.close()
import json, urllib.request
from elasticsearch_tpu_torch import Client, client, server
from elasticsearch_tpu_torch.rest.server import RestServer
n = Node(device="cpu")
srv = RestServer(n, host="127.0.0.1", port=0)
srv.start(background=True)
def http(method, path, data, ctype="application/json"):
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}",
                                 data=data.encode(), method=method,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req) as resp:
        return resp.status, json.loads(resp.read())
nd = "".join(json.dumps(x) + "\n" for i in range(30) for x in (
    {"index": {"_index": "web", "_id": str(i)}},
    {"body": "fox" if i % 3 else "dog"}))
st, r = http("POST", "/_bulk?refresh=true", nd, "application/x-ndjson")
assert st == 200 and not r["errors"] and len(r["items"]) == 30, r
st, r = http("POST", "/web/_search",
             json.dumps({"query": {"match": {"body": "fox"}}}))
assert st == 200 and r["hits"]["total"] == 20, r
assert Client(url=f"http://127.0.0.1:{srv.port}").count("web")["count"] == 30
srv.stop()
n.close()
from elasticsearch_tpu_torch.cluster.bootstrap import MultiHostCluster
members = []
for rank in range(2):
    m = Node(name=f"m{rank}", device="cpu")
    port = members[0][1].local.transport_address.rsplit(":", 1)[1] \
        if members else 0
    members.append((m, MultiHostCluster(m, rank=rank, world=2,
                                        transport_port=int(port),
                                        ping_interval=0)))
(m0, c0), (m1, c1) = members
c0.data.create_index("dist", {"settings": {"number_of_shards": 2,
                                           "number_of_replicas": 1}})
for i in range(20):
    c1.data.index_doc("dist", str(i), {"body": "fox" if i % 2 else "dog"})
c0.data.refresh("dist")
for m in (m0, m1):
    assert m.search("dist", {"query": {"match": {"body": "fox"}}})[
        "hits"]["total"] == 10
for _m, c in reversed(members):
    c.close()
for m, _c in members:
    m.close()
import importlib, pkgutil
import elasticsearch_tpu_torch
for m in pkgutil.walk_packages(elasticsearch_tpu_torch.__path__,
                               "elasticsearch_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "elasticsearch_tpu" or m.startswith("elasticsearch_tpu."))
print("LOADED", bad)
"""


def test_port_search_loads_no_jax():
    """In a fresh interpreter (this test process already holds jax)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout, out.stdout


def _sources():
    pkg = os.path.join(ROOT, "elasticsearch_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


_IMPORT = re.compile(
    r"^\s*(?:from\s+(?:jax|jaxlib|elasticsearch_tpu(?!_torch))\b"
    r"|import\s+(?:jax|jaxlib|elasticsearch_tpu(?!_torch))\b)", re.M)


def test_no_source_imports_jax_or_the_jax_package():
    offenders = []
    for path in _sources():
        with open(path, encoding="utf-8") as f:
            for m in _IMPORT.finditer(f.read()):
                offenders.append(f"{os.path.relpath(path, ROOT)}: "
                                 f"{m.group(0).strip()}")
    assert not offenders, offenders


def test_node_without_device_raises_when_no_card(monkeypatch):
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Node()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Node(device="cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("mps")
