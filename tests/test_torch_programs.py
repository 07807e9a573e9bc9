"""The port's program observatory and census against the reference's.

``monitor/programs.py``, ``resources/census.py`` and
``tracing/retrace.py`` of both packages fed the same seeded corpus and
the same traffic: the recorded bodies and their hit counts (hottest
first), the census merge with its caps and decay over the same rows, the
registry's caps, the REST views' columns (``_cat/programs``,
``/_nodes/_local/xla/programs``) and what a first touch means in the
port (a key's first dispatch in the process, a library built or loaded):
the ``warmup`` label of a search and the profile's ``retraces``.

The reference's AOT executable cache is off in every case (ROADMAP C26:
it serves an executable cached for one device layout to another).
"""
import json

import pytest

from _torch_parity import MAPPING, corpus
from elasticsearch_tpu.index import ivf_cache as ref_ivf_cache
from elasticsearch_tpu.monitor import programs as ref_programs
from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu.resources import census as ref_census
from elasticsearch_tpu.rest.server import RestController as RefController
from elasticsearch_tpu_torch.index import ivf_cache
from elasticsearch_tpu_torch.monitor import programs
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.resources import census
from elasticsearch_tpu_torch.rest.server import RestController
from elasticsearch_tpu_torch.tracing import retrace

DOCS = corpus(300)

#: the same traffic for both: match, bool and a filtered term, hottest
#: first by construction (3, 2, 1 requests), and bodies the census skips
TRAFFIC = ([{"query": {"match": {"body": "quick fox"}}, "size": 5}] * 3
           + [{"query": {"bool": {"must": [{"match": {"body": "search"}}],
                                  "filter": [{"term": {"tag": "t3"}}]}}}] * 2
           + [{"query": {"match": {"body": "river ocean"}}, "size": 7}])
SKIPPED = [{"query": {"match": {"body": "quick"}}, "profile": True},
           {"query": {"match": {"body": "fox"}}, "scroll": "1m"}]


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    from elasticsearch_tpu.parallel import aot as ref_aot

    monkeypatch.setattr(ref_aot, "_ENABLED", False)
    for mod in (programs, ref_programs):
        mod.REGISTRY.reset()
    for mod in (census, ref_census):
        mod._DECAYED.clear()
    for mod in (ivf_cache, ref_ivf_cache):
        mod.reset()
    yield
    for mod in (programs, ref_programs):
        mod.REGISTRY.reset()
    for mod in (ivf_cache, ref_ivf_cache):
        mod.reset()


def _nodes(index="cp", data=None):
    ref = RefNode(name="ref", data_path=data and f"{data}/ref")
    port = Node(name="port", data_path=data and f"{data}/port", device="cpu")
    for n in (ref, port):
        n.create_index(index, {"mappings": MAPPING})
        svc = n.indices[index]
        for doc_id, src in DOCS:
            svc.index_doc(doc_id, src)
        svc.refresh()
    return ref, port


def _hits(resp):
    return [(h["_id"], round(h["_score"], 5)) for h in resp["hits"]["hits"]]


def test_census_bodies_and_hits_match_the_reference_hottest_first():
    ref, port = _nodes()
    try:
        for body in TRAFFIC + SKIPPED:
            r, p = (n.search("cp", dict(body)) for n in (ref, port))
            assert p["hits"]["total"] == r["hits"]["total"]
            assert [h["_id"] for h in p["hits"]["hits"]] == \
                [h["_id"] for h in r["hits"]["hits"]]
        got = programs.REGISTRY.bodies("cp")
        want = ref_programs.REGISTRY.bodies("cp")
        assert got == want
        assert [b["hits"] for b in got] == [3, 2, 1]
        assert json.loads(got[0]["body"]) == TRAFFIC[0]
        # the port's census keys: its dispatch points, each hit counted
        keys = programs.REGISTRY.census("cp")
        assert keys and all(k["hits"] >= 1 for k in keys)
        assert {k["program"] for k in keys} <= {
            "mesh_dsl", "host_dsl", "bm25_fused_topk"}
    finally:
        ref.close()
        port.close()


def test_census_sampling_matches_the_reference(monkeypatch):
    """Past the full-fidelity window a body is recorded 1 in 8 with
    weight 8, in both packages."""
    from elasticsearch_tpu.index.index_service import \
        IndexService as RefIndexService
    from elasticsearch_tpu_torch.index.index_service import IndexService

    for cls in (RefIndexService, IndexService):
        monkeypatch.setattr(cls, "_CENSUS_FULL", 4)
    ref, port = _nodes()
    try:
        for _ in range(21):
            for n in (ref, port):
                n.search("cp", dict(TRAFFIC[-1]))
        got = programs.REGISTRY.bodies("cp")
        assert got == ref_programs.REGISTRY.bodies("cp")
        assert got[0]["hits"] == 4 + 8 * 2
    finally:
        ref.close()
        port.close()


ROWS_PERSISTED = [{"program": "a", "shapes": "s", "field": "", "hits": 5},
                  {"program": "b", "shapes": "s", "field": "f", "hits": 3},
                  {"program": "c", "shapes": "t", "field": "", "hits": 9}]
ROWS_LIVE = [{"program": "a", "shapes": "s", "field": "", "hits": 2},
             {"program": "b", "shapes": "s", "field": "f", "hits": 7},
             {"program": "d", "shapes": "u", "field": "", "hits": 1}]


@pytest.mark.parametrize("decay", [False, True])
def test_merge_rows_matches_the_reference(decay):
    got = census._merge_rows(ROWS_PERSISTED, ROWS_LIVE, census._key_id,
                             decay=decay)
    want = ref_census._merge_rows(ROWS_PERSISTED, ROWS_LIVE,
                                  ref_census._key_id, decay=decay)
    assert got == want
    by = {r["program"]: r["hits"] for r in got}
    assert by["a"] == 5 and by["b"] == 7  # max, never a sum
    assert by["c"] == (4 if decay else 9)  # unreinforced rows halve


def test_store_merge_caps_and_decay_match_the_reference(tmp_path):
    """Three generations of shifting rows, stored by both packages with
    a restart (a cleared decay set) before each: the same persisted
    keys and bodies, capped, hottest first, the unreinforced halved."""
    for mod, sub in ((ivf_cache, "port"), (ref_ivf_cache, "ref")):
        mod.register(str(tmp_path / sub))
    out = []
    for cmod in (census, ref_census):
        for gen in range(3):
            cmod._DECAYED.clear()
            cmod.store_census(
                "cap",
                keys=[{"program": f"p{gen}_{i}", "shapes": "s",
                       "field": "", "hits": gen + 1} for i in range(700)],
                bodies=[{"body": json.dumps({"g": gen, "i": i}),
                         "hits": gen + 1} for i in range(40)])
        out.append(cmod.load_census("cap"))
    got, want = out
    assert got["keys"] == want["keys"] and got["bodies"] == want["bodies"]
    assert len(got["keys"]) == census.KEY_CAP == ref_census.KEY_CAP
    assert len(got["bodies"]) == census.BODY_CAP == ref_census.BODY_CAP
    assert all(json.loads(b["body"])["g"] == 2 for b in got["bodies"][:40])
    assert got["backend"] == programs.backend_fingerprint()


def test_v1_census_and_damage_load_as_the_reference(tmp_path):
    for mod, sub in ((ivf_cache, "port"), (ref_ivf_cache, "ref")):
        mod.register(str(tmp_path / sub))
    v1 = {"version": 1, "index": "v", "backend": "x",
          "keys": [{"program": "a", "shapes": "s", "field": ""}]}
    loaded = []
    for imod, cmod in ((ivf_cache, census), (ref_ivf_cache, ref_census)):
        imod.store_blob(cmod.census_key("v"), imod.frame_blob(v1), "census")
        loaded.append(cmod.load_census("v"))
        imod.store_blob(cmod.census_key("v"), b"0" * 40 + b"\n{}", "census")
        assert cmod.load_census("v") is None  # deleted: a miss
        assert imod.load_blob(cmod.census_key("v"), "census") is None
    assert loaded[0] == loaded[1]
    assert loaded[0]["keys"][0]["hits"] == 1 and loaded[0]["bodies"] == []
    assert census.census_key("v") == ref_census.census_key("v")


def test_body_cap_and_key_cap_match_the_reference():
    assert programs.ProgramRegistry._BODY_CAP == \
        ref_programs.ProgramRegistry._BODY_CAP
    regs = [programs.ProgramRegistry(), ref_programs.ProgramRegistry()]
    for reg in regs:
        for i in range(reg._BODY_CAP):
            reg.record_body("ev", f"early_{i}", n=1 + i % 3)
        for _ in range(3):
            reg.record_body("ev", "late_hot", n=2)
    assert regs[0].bodies("ev") == regs[1].bodies("ev")
    assert any(b["body"] == "late_hot" for b in regs[0].bodies("ev"))
    # past the key cap new keys collapse into _other_
    reg = programs.ProgramRegistry()
    reg._MAX_KEYS = 4
    for i in range(6):
        reg.record_execute(f"k{i}", "Q=1", 0.001)
    rows = {r["program"]: r["calls"] for r in reg.snapshot()}
    assert len(rows) == 5 and rows["_other_"] == 2


@pytest.mark.parametrize("args,kwargs", [
    ((), None),
    (("a", 3, 2.5, True), {"k": 10}),
    ((("x", 1), ["y"]), {"b": "z", "a": 1}),
])
def test_shape_and_static_sigs_match_the_reference(args, kwargs):
    assert programs.shape_sig(args, kwargs) == \
        ref_programs.shape_sig(args, kwargs)
    dims = dict(kwargs or {}, Q=8, D=1024)
    assert programs.static_sig(**dims) == ref_programs.static_sig(**dims)


def test_shape_sig_of_arrays_and_tensors():
    import numpy as np
    import torch

    a = np.zeros((8, 1024), np.float32)
    assert programs.shape_sig((a,)) == ref_programs.shape_sig((a,)) == \
        "f32[8,1024]"
    assert programs.shape_sig((torch.zeros(8, 16, dtype=torch.int32),
                               torch.zeros(3, dtype=torch.bfloat16))) == \
        "i32[8,16]|bf16[3]"


def test_rest_views_have_the_references_columns_and_keys():
    ref, port = _nodes()
    try:
        for body in TRAFFIC:
            for n in (ref, port):
                n.search("cp", dict(body))
        rc, pc = RefController(ref), RestController(port)
        (rs, rb), (ps, pb) = (c.dispatch("GET", "/_cat/programs", {}, b"")
                              for c in (rc, pc))
        assert rs == ps == 200
        assert pb.default == rb.default
        assert pb and all(set(r) == set(rb.default) for r in pb)
        assert {r["backend"] for r in pb} == {"cpu/cpu/n=1"}
        assert all(r["cold"] == "false" for r in pb
                   if r["program"] == "host_dsl" and int(r["calls"]))
        (rs, rb), (ps, pb) = (c.dispatch(
            "GET", "/_nodes/_local/xla/programs", {}, b"") for c in (rc, pc))
        assert rs == ps == 200
        assert set(pb) == set(rb) == {"backend", "totals", "programs",
                                      "census"}
        assert set(pb["totals"]) == set(rb["totals"])
        assert set(pb["programs"][0]) == set(rb["programs"][0])
        assert list(pb["census"]) == list(rb["census"]) == ["cp"]
        assert set(pb["census"]["cp"][0]) == set(rb["census"]["cp"][0])
        # the same rows as text, with a header under v
        ps, text = pc.dispatch("GET", "/_cat/programs", {"v": "true"}, b"")
        assert ps == 200
    finally:
        ref.close()
        port.close()


def test_first_touch_labels_the_first_search_and_the_profile():
    """After the keys are forgotten (a new process), a search's first
    run of its dispatch key is labelled ``warmup="true"`` and its
    profile counts the first touch; the same search again is ``false``
    with ``retraces`` 0."""
    _ref, port = _nodes()
    _ref.close()
    try:
        retrace.reset()
        body = {"query": {"match": {"body": "quick fox"}}, "profile": True}
        first, second = (port.search("cp", dict(body)) for _ in range(2))
        assert sum(s["tpu"]["retraces"]
                   for s in first["profile"]["shards"]) >= 1
        assert all(s["tpu"]["retraces"] == 0
                   for s in second["profile"]["shards"])
        rows = port.metrics.summaries()["estpu_search_duration_seconds"]
        by = {r["labels"]["warmup"]: r["count"] for r in rows}
        assert by == {"true": 1, "false": 1}
        row = [r for r in programs.REGISTRY.snapshot()
               if r["program"] == "host_dsl"][0]
        assert row["compiles"] == 1 and row["calls"] == 1
        assert port.nodes_stats()["nodes"][port.node_id]["programs"][
            "compiles"] >= 1
    finally:
        port.close()


def test_first_touch_is_counted_per_thread():
    import threading

    key = ("k_thread", "Q=1", programs.backend_fingerprint())
    retrace.reset()
    snap = retrace.snapshot()
    seen = []
    th = threading.Thread(target=lambda: seen.append(
        retrace.first_dispatch(key)))
    th.start()
    th.join()
    assert seen == [True]
    assert retrace.traces_since(snap) == 0  # another thread's first touch
    assert retrace.first_dispatch(key) is False
    total = retrace.auditor().total()
    retrace.note()
    assert retrace.traces_since(snap) == 1
    assert retrace.auditor().total() == total + 1
