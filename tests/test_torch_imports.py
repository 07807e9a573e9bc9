"""The PyTorch port stands alone: it imports neither jax nor the JAX
package (a phrase, a term expansion and a query_string included), and
its entry point never falls back to the CPU on its own."""
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
n.close()
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
