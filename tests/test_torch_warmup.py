"""The port's pre-warm service, warmers and census flushes against the
reference's.

Both packages' ``serving/warmup.py`` over the same seeded corpus and the
same persisted census: the statuses ``complete``, ``cooldown``,
``deferred``, ``backend_mismatch`` and ``canceled``, the ``/_warmup``
JSON, stored warmers at every refresh (a broken one never fails it),
the watchdog's census flush, the census on the recovery stream, and the
port's restart: a new node over the same data path replays the census
and serves its first request as ``warmup="false"`` with the hits the
recording process served.

The reference's AOT executable cache is off in every case (ROADMAP C26).
"""
import threading

import pytest

from _torch_cluster import PORT, Trio
from _torch_parity import MAPPING, corpus
from elasticsearch_tpu import resources as ref_resources
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

DOCS = corpus(240, seed=3)
BODIES = [{"query": {"match": {"body": "quick fox"}}, "size": 5},
          {"query": {"match": {"body": "search engine"}}, "size": 4},
          {"query": {"bool": {"must": [{"match": {"body": "river"}}],
                              "filter": [{"term": {"tag": "t2"}}]}}}]


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    from elasticsearch_tpu.parallel import aot as ref_aot

    monkeypatch.setattr(ref_aot, "_ENABLED", False)
    monkeypatch.delenv("ESTPU_WARMUP", raising=False)
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


def _pair(tmp_path, index="wu", searches=1):
    """A reference and a port node, each over its own data path, the
    same docs indexed and ``BODIES`` searched ``searches`` times, the
    census stored."""
    ref = RefNode(name="ref", data_path=str(tmp_path / "ref"))
    port = Node(name="port", data_path=str(tmp_path / "port"),
                device="cpu")
    for n, cmod in ((ref, ref_census), (port, census)):
        n.create_index(index, {"mappings": MAPPING})
        svc = n.indices[index]
        for doc_id, src in DOCS:
            svc.index_doc(doc_id, src)
        svc.refresh()
        for _ in range(searches):
            for body in BODIES:
                n.search(index, dict(body))
        cmod.store_census(index)
    return ref, port


def _close(*nodes):
    for n in nodes:
        n.close()


def _labels(node, index):
    rows = node.metrics.summaries().get("estpu_search_duration_seconds", [])
    return {r["labels"]["warmup"]: r["count"] for r in rows
            if r["labels"]["index"] == index}


def _same_run(got, want):
    for k in ("status", "replayed", "errors", "deferrals", "reason",
              "index"):
        assert got.get(k) == want.get(k), k


def test_run_replays_then_cooldown_as_the_reference(tmp_path):
    ref, port = _pair(tmp_path)
    try:
        runs = [n.serving.warmup.run_index("wu", "test") for n in (ref, port)]
        _same_run(runs[1], runs[0])
        assert runs[1]["status"] == "complete"
        assert runs[1]["replayed"] == len(BODIES)
        assert _labels(port, "wu").get("prewarm") == \
            _labels(ref, "wu").get("prewarm") == len(BODIES)
        # replays never inflate their own work list
        assert programs.REGISTRY.bodies("wu") == \
            ref_programs.REGISTRY.bodies("wu")
        assert all(b["hits"] == 1 for b in programs.REGISTRY.bodies("wu"))
        for n in (ref, port):
            assert n.serving.warmup.kick("again", ["wu"]) == []
        again = [n.serving.warmup.run_index("wu", "queued")
                 for n in (ref, port)]
        _same_run(again[1], again[0])
        assert again[1]["status"] == "cooldown"
        recs = [n.serving.warmup.runs["wu"] for n in (ref, port)]
        assert recs[1]["status"] == recs[0]["status"] == "complete"
        assert recs[1]["cooldown_skips"] == recs[0]["cooldown_skips"] == 2
    finally:
        _close(ref, port)


def test_breaker_denial_defers_as_the_reference(tmp_path):
    ref, port = _pair(tmp_path, index="bd")
    brs = [ref_resources.BREAKERS.breaker("request"),
           port.breakers.breaker("request")]
    limits = [b.limit for b in brs]
    try:
        for b in brs:
            b.limit = 0
        for n in (ref, port):
            n.serving.warmup.config["defer_wait_s"] = 0.001
        runs = [n.serving.warmup.run_index("bd", "test") for n in (ref, port)]
        _same_run(runs[1], runs[0])
        assert runs[1]["status"] == "deferred" and runs[1]["deferrals"] >= 1
        for b, lim in zip(brs, limits):
            b.limit = lim
        runs = [n.serving.warmup.run_index("bd", "retry")
                for n in (ref, port)]
        _same_run(runs[1], runs[0])
        assert runs[1]["status"] == "complete"
    finally:
        for b, lim in zip(brs, limits):
            b.limit = lim
        _close(ref, port)


def _cancel_mid_run(node, index):
    svc = node.indices[index]
    started, release = threading.Event(), threading.Event()
    real = svc.search

    def slow(body, **kw):
        started.set()
        release.wait(timeout=10.0)
        return real(body, **kw)

    svc.search = slow
    out = {}
    th = threading.Thread(target=lambda: out.update(
        res=node.serving.warmup.run_index(index, "test")), daemon=True)
    th.start()
    assert started.wait(timeout=10.0)
    (task,) = [t for t in node.tasks.list_tasks()
               if t.action == "cluster:admin/warmup"]
    node.tasks.cancel(task.id, reason="test cancel")
    release.set()
    th.join(timeout=10.0)
    svc.search = real
    return out["res"]


def test_cancel_stops_at_a_body_boundary_as_the_reference(tmp_path):
    ref, port = _pair(tmp_path, index="cx")
    try:
        runs = [_cancel_mid_run(n, "cx") for n in (ref, port)]
        _same_run(runs[1], runs[0])
        assert runs[1]["status"] == "canceled"
        assert not [t for t in port.tasks.list_tasks()
                    if t.action == "cluster:admin/warmup"]
        assert programs.REGISTRY.inflight_snapshot() == []
        assert port.search("cx", dict(BODIES[0]))["hits"]["total"] > 0
    finally:
        _close(ref, port)


def test_foreign_backend_is_refused_as_the_reference(tmp_path):
    ref, port = _pair(tmp_path, index="bm")
    try:
        for imod, cmod in ((ref_ivf_cache, ref_census), (ivf_cache, census)):
            payload = cmod.load_census("bm")
            payload["backend"] = "cuda/NVIDIA_H100_80GB_HBM3/sm_90/n=4"
            imod.store_blob(cmod.census_key("bm"), imod.frame_blob(payload),
                            "census")
        runs = [n.serving.warmup.run_index("bm", "test") for n in (ref, port)]
        _same_run(runs[1], runs[0])
        assert runs[1]["status"] == "backend_mismatch"
        assert runs[1]["census_backend"] == runs[0]["census_backend"]
    finally:
        _close(ref, port)


def test_no_census_and_a_disabled_service(tmp_path, monkeypatch):
    ref = RefNode(name="ref")
    port = Node(name="port", device="cpu")
    try:
        for n in (ref, port):
            n.create_index("nc", {"mappings": MAPPING})
        runs = [n.serving.warmup.run_index("nc", "test") for n in (ref, port)]
        _same_run(runs[1], runs[0])
        assert runs[1]["status"] == "no_census"
        monkeypatch.setenv("ESTPU_WARMUP", "0")
        assert port.serving.warmup.kick("boot") == \
            ref.serving.warmup.kick("boot") == []
        monkeypatch.delenv("ESTPU_WARMUP")
        for n in (ref, port):
            n.serving.apply_cluster_settings(
                {"serving.warmup.enabled": "false"})
        assert not port.serving.warmup.enabled
        assert port.serving.warmup.kick("boot") == []
    finally:
        _close(ref, port)


def test_warmup_routes_answer_as_the_reference(tmp_path):
    ref, port = _pair(tmp_path, index="rk")
    try:
        rc, pc = RefController(ref), RestController(port)
        outs = [c.dispatch("POST", "/rk/_warmup", {}, b"") for c in (rc, pc)]
        assert outs[1] == outs[0] == (200, {"acknowledged": True,
                                            "queued": ["rk"]})
        for n in (ref, port):
            assert n.serving.warmup.wait_idle(timeout=30.0)
        (rs, rb), (ps, pb) = (c.dispatch("GET", "/_warmup", {}, b"")
                              for c in (rc, pc))
        assert rs == ps == 200
        assert set(pb) == set(rb) == {"enabled", "queued", "active", "runs"}
        assert pb["queued"] == rb["queued"] == [] and pb["active"] is None
        assert set(pb["runs"]) == set(rb["runs"]) == {"rk"}
        _same_run(pb["runs"]["rk"], rb["runs"]["rk"])
        assert set(pb["runs"]["rk"]) == set(rb["runs"]["rk"])
        assert pb["runs"]["rk"]["status"] == "complete"
        # inside the cooldown: nothing queued, the run keeps its record
        outs = [c.dispatch("POST", "/_warmup", {}, b"") for c in (rc, pc)]
        assert outs[1] == outs[0] == (200, {"acknowledged": True,
                                            "queued": []})
        outs = [c.dispatch("POST", "/nope/_warmup", {}, b"")
                for c in (rc, pc)]
        assert outs[1][0] == outs[0][0] == 404
        assert outs[1][1]["error"]["type"] == outs[0][1]["error"]["type"]
        st = port.nodes_stats()["nodes"][port.node_id]["serving"]["warmup"]
        assert st["runs"]["rk"]["status"] == "complete"
    finally:
        _close(ref, port)


WARMER = {"query": {"match": {"body": "quick fox"}}, "size": 5}


def test_warmers_run_at_every_refresh_with_the_same_hits():
    """A stored warmer runs at each refresh in both packages (the shard
    counts its query), its search lands in no latency series, and the
    port's next search of the warmer's body is steady (``false``)."""
    ref = RefNode(name="ref")
    port = Node(name="port", device="cpu")
    try:
        for n in (ref, port):
            n.create_index("wm", {"mappings": MAPPING, "warmers": {
                "w1": {"source": WARMER},
                "broken": {"source": {"query": {"no_such_query": {}}}}}})
            svc = n.indices["wm"]
            for doc_id, src in DOCS[:120]:
                svc.index_doc(doc_id, src)
        for n in (ref, port):
            n.indices["wm"].refresh()  # the broken warmer does not raise
        retrace.reset()
        for n in (ref, port):
            n.indices["wm"].index_doc("late", {"body": "quick fox late"})
            n.indices["wm"].refresh()
        assert _labels(port, "wm") == _labels(ref, "wm") == {}
        rows = [r for r in programs.REGISTRY.snapshot()
                if r["program"] in ("mesh_dsl", "host_dsl")]
        assert rows and sum(r["compiles"] for r in rows) >= 1
        r, p = (n.search("wm", dict(WARMER)) for n in (ref, port))
        assert [h["_id"] for h in p["hits"]["hits"]] == \
            [h["_id"] for h in r["hits"]["hits"]]
        assert p["hits"]["total"] == r["hits"]["total"]
        assert _labels(port, "wm") == {"false": 1}
        # the shards counted the warmers' queries as the reference's did
        rq, pq = (n.nodes_stats()["nodes"][n.node_id]["indices"]["search"][
            "query_total"] for n in (ref, port))
        assert pq == rq
    finally:
        _close(ref, port)


def test_watchdog_tick_flushes_the_census_as_the_reference(tmp_path):
    ref, port = _pair(tmp_path, index="wf", searches=0)
    try:
        loaded = []
        for n, cmod, reg in ((ref, ref_census, ref_programs.REGISTRY),
                             (port, census, programs.REGISTRY)):
            n.search("wf", dict(BODIES[0]))
            assert cmod.load_census("wf") is None  # not yet flushed
            n.watchdog.config["census_flush_every_s"] = 0.0
            n.watchdog.run_once()
            loaded.append(cmod.load_census("wf"))
            gen = reg.census_generation()
            n.watchdog.run_once()  # nothing moved: no write
            assert reg.census_generation() == gen
        assert loaded[1]["bodies"] == loaded[0]["bodies"]
        assert loaded[1]["bodies"][0]["hits"] == 1
        # the cadence: a moved census waits out the interval
        port.watchdog.config["census_flush_every_s"] = 3600.0
        port.search("wf", dict(BODIES[0]))
        port.watchdog.run_once()
        assert census.load_census("wf")["bodies"][0]["hits"] == 1
    finally:
        _close(ref, port)


def test_a_restarted_node_prewarms_and_serves_warm(tmp_path):
    """The port's restart: close stores the census; a new node over the
    data path (its keys forgotten, as in a new process) replays it before
    the first request, which is then ``warmup="false"`` with the hits of
    the process that recorded the census."""
    data = str(tmp_path / "d")
    first = Node(name="a", data_path=data, device="cpu")
    first.create_index("rs", {"mappings": MAPPING})
    for doc_id, src in DOCS:
        first.indices["rs"].index_doc(doc_id, src)
    first.indices["rs"].refresh()
    want = [first.search("rs", dict(b)) for b in BODIES]
    first.close()
    assert census.load_census("rs")["bodies"]
    programs.REGISTRY.reset()
    retrace.reset()
    ivf_cache.reset()
    second = Node(name="b", data_path=data, device="cpu")
    try:
        assert second.serving.warmup.kick("boot") == ["rs"]
        assert second.serving.warmup.wait_idle(timeout=60.0)
        run = second.serving.warmup.runs["rs"]
        assert run["status"] == "complete"
        assert run["replayed"] == len(BODIES)
        assert run["keys_warm_after"] == run["keys_total"] > 0
        compiles = programs.REGISTRY.stats()["compiles"]
        got = [second.search("rs", dict(b)) for b in BODIES]
        assert programs.REGISTRY.stats()["compiles"] == compiles
        assert _labels(second, "rs") == {"prewarm": len(BODIES),
                                         "false": len(BODIES)}
        for g, w in zip(got, want):
            assert g["hits"]["total"] == w["hits"]["total"]
            assert [(h["_id"], h["_score"]) for h in g["hits"]["hits"]] == \
                [(h["_id"], h["_score"]) for h in w["hits"]["hits"]]
    finally:
        second.close()


def test_census_export_and_adopt_match_the_reference(tmp_path):
    ref, port = _pair(tmp_path, index="xa")
    try:
        shipped = [cmod.export_census("xa") for cmod in (ref_census, census)]
        assert shipped[1]["bodies"] == shipped[0]["bodies"]
        assert shipped[1]["keys"]
        for imod, sub in ((ivf_cache, "port"), (ref_ivf_cache, "ref")):
            imod.reset()
            imod.register(str(tmp_path / "target" / sub))
        for cmod, payload in zip((ref_census, census), shipped):
            assert cmod.load_census("xa") is None
            assert cmod.adopt_census("xa", payload) is True
        got = [cmod.load_census("xa") for cmod in (ref_census, census)]
        assert got[1]["bodies"] == got[0]["bodies"] == shipped[1]["bodies"]
        # refused: a foreign backend, garbage; malformed rows skipped
        for cmod in (ref_census, census):
            bad = dict(shipped[1], index="fb", backend="tpu/v99")
            assert cmod.adopt_census("fb", bad) is False
            assert cmod.adopt_census("fb", None) is False
            assert cmod.adopt_census("fb", {"index": "other"}) is False
        mixed = {"version": 2, "index": "fb", "bodies": [{"body": ""}],
                 "keys": [{"program": "bad", "shapes": "s", "hits": None},
                          {"program": "ok", "shapes": "s", "hits": "1.5"},
                          {"program": "good", "shapes": "s", "hits": 3}]}
        for cmod, pmod in ((ref_census, ref_programs), (census, programs)):
            assert cmod.adopt_census(
                "fb", dict(mixed, backend=pmod.backend_fingerprint()))
            assert {k["program"] for k in cmod.load_census("fb")["keys"]} \
                == {"good"}
    finally:
        _close(ref, port)


def test_recovery_ships_the_census_and_kernel_library_blobs(tmp_path):
    """A shard-sync reply carries the source's census (one payload for
    every shard of a recovery) and the kernel-library blobs the target
    reported missing; the target adopts both and kicks its warmup."""
    from elasticsearch_tpu_torch.cluster.search_action import \
        DistributedDataService

    t = Trio(PORT, world=2)
    try:
        c0, c1 = t[0], t[1]
        body = {"settings": {"number_of_shards": 1,
                             "number_of_replicas": 0},
                "mappings": {"properties": {"body": {"type": "text"}}}}
        c0.data.create_index("mv", dict(body))
        for i in range(8):
            c0.data.index_doc("mv", str(i), {"body": f"alpha beta w{i}"})
        c0.data.refresh("mv")
        c0.node.search("mv", {"query": {"match": {"body": "alpha"}},
                              "size": 4})
        ivf_cache.register(str(tmp_path / "source-tier"))
        ivf_cache.store_blob("kso_codec_x", b"framed library", "kso",
                             memory=False)
        resp = c0.data._on_shard_sync({"index": "mv", "shard": 0,
                                       "kso_have": [], "target": "t1"})
        assert resp["census"]["bodies"]
        assert set(resp["kso_blobs"]) == {"kso_codec_x"}
        again = c0.data._on_shard_sync({"index": "mv", "shard": 0,
                                        "kso_have": [], "target": "t1"})
        assert again["census"] is resp["census"]  # one payload a window
        assert "kso_blobs" not in again  # one shipment a window a target
        # the target: no blob tier shared with the source, no flush
        # side channel; only the stream can carry the census
        DistributedDataService._flush_census_debounced, saved = \
            (lambda self, ix: None), \
            DistributedDataService._flush_census_debounced
        sent = []
        send = c1.data._send
        c1.data._send = lambda *a, **kw: (sent.append(a[2]), send(
            *a, **kw))[1]
        try:
            ivf_cache.reset()
            ivf_cache.register(str(tmp_path / "target-tier"))
            c0.data._census_export_ts = {}
            res = c1.data._on_recover({
                "index": "mv", "shard": 0, "source": c0.local.node_id,
                "target": c1.local.node_id, "body": body})
        finally:
            DistributedDataService._flush_census_debounced = saved
            c1.data._send = send
        assert res["mode"] in ("ops", "full")
        assert census.load_census("mv")["bodies"]
        # the target told the source which blobs it holds (none: the
        # members of this process share one tier, so the source had
        # none left to ship); what a source ships, the target seeds
        assert [r["kso_have"] for r in sent if "kso_have" in r] == [[]]
        assert c1.data._adopt_library_blobs(resp["kso_blobs"]) == 1
        assert ivf_cache.load_blob("kso_codec_x", "kso") == b"framed library"
        wu = c1.node.serving.warmup
        assert wu.wait_idle(timeout=30.0)
        assert wu.runs["mv"]["status"] in ("complete", "cooldown")
    finally:
        t.close()
