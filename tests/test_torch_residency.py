"""Fielddata under pressure: the port's residency registry
(``resources/residency.py``), lazy evictable columns, partial shard
results on a breaker trip and the ``fielddata`` stats, against the JAX
package on the CPU.

Each scenario of the reference's ``tests/unit/test_resources.py`` (and
its PQ eviction case in ``tests/unit/test_pq.py``) runs on both
packages with the same seeded writes and bodies: the reference's
process-wide breakers and registry are swapped for isolated ones (its
own ``iso`` fixture), the port's belong to each ``Node`` or registry.
Hits, ``_shards``, failure entries and the ``fielddata`` stats are held
equal; the registry's counters where both packages hold the same
handles. Sort mirrors are handles of the port alone, so the stats'
parity runs on bodies without a sort.
"""
import copy
import functools
import gc
import threading

import numpy as np
import pytest
import torch

from elasticsearch_tpu import resources as ref_resources
from elasticsearch_tpu.index import segment as ref_segmod
from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu.resources.breakers import \
    CircuitBreakerService as RefBreakers
from elasticsearch_tpu.resources.residency import ResidencyRegistry
from elasticsearch_tpu.utils.errors import \
    CircuitBreakingException as RefCBE
from elasticsearch_tpu.utils.faults import FAULTS as REF_FAULTS
from elasticsearch_tpu_torch import Node
from elasticsearch_tpu_torch.cluster.routing import shard_id_for
from elasticsearch_tpu_torch.index import segment as port_segmod
from elasticsearch_tpu_torch.ops.pq import build_pq, place_pq
from elasticsearch_tpu_torch.resources import residency as port_res
from elasticsearch_tpu_torch.resources.breakers import CircuitBreakerService
from elasticsearch_tpu_torch.resources.residency import Residency
from elasticsearch_tpu_torch.utils.errors import CircuitBreakingException
from elasticsearch_tpu_torch.utils.faults import FAULTS

from _torch_parity import clustered

CPU = torch.device("cpu")
MAPPING = {"properties": {"body": {"type": "text"}, "n": {"type": "long"},
                          "tag": {"type": "keyword"},
                          "price": {"type": "double"}}}


@pytest.fixture
def iso(monkeypatch):
    """The reference's isolated breakers and registry (its ``iso``), and
    a port registry of its own at the same capacity."""
    svc = RefBreakers(capacity=1 << 30)
    reg = ResidencyRegistry(svc)
    monkeypatch.setattr(ref_resources, "BREAKERS", svc)
    monkeypatch.setattr(ref_resources, "RESIDENCY", reg)
    port = Residency(CPU, CircuitBreakerService(capacity=1 << 30))
    yield (svc, reg), (port.breakers, port)
    REF_FAULTS.clear()
    FAULTS.clear()


def _both(iso):
    """[(package, breakers, registry, as_numpy)] for a scenario to run on
    each package in turn."""
    (rsvc, rreg), (psvc, preg) = iso
    return [("ref", rsvc, rreg, np.asarray),
            ("port", psvc, preg, lambda t: t.numpy())]


# -- the registry --------------------------------------------------------------

def test_put_evict_rehydrate_round_trip(iso):
    seen = {}
    for pkg, _svc, reg, arr in _both(iso):
        host = np.arange(64, dtype=np.float32)
        h = reg.put_array(host, label="t.values", tier="fielddata")
        assert h.resident
        dev1 = arr(h.get()).copy()
        assert h.evict() and not h.resident
        assert not h.evict()  # idempotent
        dev2 = arr(h.get())  # rehydrated from the host mirror
        assert h.resident
        np.testing.assert_array_equal(dev1, dev2)
        np.testing.assert_array_equal(dev2, host)
        st = dict(reg.stats()["tiers"]["fielddata"])
        assert st.pop("rehydrate_time_in_nanos") > 0
        seen[pkg] = (st, reg.stats()["pinned"])
    assert seen["port"] == seen["ref"]
    assert seen["port"][0] == {"resident_bytes": 256, "handles": 1,
                               "loads": 1, "evictions": 1,
                               "rehydrations": 1}


def test_pressure_evicts_lru_before_tripping(iso):
    seen = {}
    for pkg, svc, reg, _arr in _both(iso):
        svc.apply_cluster_settings({
            "indices.breaker.fielddata.limit": int(64 * 4 * 2.5),
            "indices.breaker.fielddata.overhead": 1.0})
        a = reg.put_array(np.zeros(64, np.float32), label="a",
                          tier="fielddata")
        b = reg.put_array(np.zeros(64, np.float32), label="b",
                          tier="fielddata")
        b.get()
        a.get()  # a most recently used: b is the victim
        c = reg.put_array(np.zeros(64, np.float32), label="c",
                          tier="fielddata")
        seen[pkg] = (a.resident, b.resident, c.resident,
                     reg.stats()["tiers"]["fielddata"]["evictions"],
                     svc.breaker("fielddata").used,
                     svc.breaker("fielddata").trip_count)
    assert seen["port"] == seen["ref"] == (True, False, True, 1, 512, 0)


def test_trip_when_nothing_evictable_covers_it(iso):
    for pkg, svc, reg, _arr in _both(iso):
        cbe = RefCBE if pkg == "ref" else CircuitBreakingException
        svc.apply_cluster_settings({"indices.breaker.fielddata.limit": 16})
        with pytest.raises(cbe) as ei:
            reg.put_array(np.zeros(64, np.float32), label="big",
                          tier="fielddata")
        assert ei.value.status == 429
        assert "[fielddata] Data too large, data for [big]" in str(ei.value)
        assert svc.breaker("fielddata").trip_count == 1
        # a best-effort caller gets None, not an error
        assert reg.put_array(np.zeros(64, np.float32), label="big",
                             tier="fielddata", best_effort=True) is None
        assert svc.breaker("fielddata").used == 0
    # the port closes a refused handle at once (the reference's leaves
    # with its collection)
    assert iso[1][1].stats()["tiers"]["fielddata"]["handles"] == 0


def test_failed_placement_releases_its_reservation(iso, monkeypatch):
    import elasticsearch_tpu.resources.residency as ref_res

    for pkg, svc, reg, _arr in _both(iso):
        mod = ref_res if pkg == "ref" else port_res
        orig = mod.ResidentArray._place

        def boom(self):
            raise RuntimeError("transfer failed")

        monkeypatch.setattr(mod.ResidentArray, "_place", boom)
        with pytest.raises(RuntimeError):
            reg.put_array(np.zeros(64, np.float32), label="x",
                          tier="fielddata")
        assert svc.breaker("fielddata").used == 0
        monkeypatch.setattr(mod.ResidentArray, "_place", orig)
        h = reg.put_array(np.zeros(64, np.float32), label="x",
                          tier="fielddata")
        h.evict()
        monkeypatch.setattr(mod.ResidentArray, "_place", boom)
        with pytest.raises(RuntimeError):
            h.get()  # the rehydration leaks nothing either
        assert svc.breaker("fielddata").used == 0
        monkeypatch.setattr(mod.ResidentArray, "_place", orig)
        assert tuple(h.get().shape) == (64,)
        assert svc.breaker("fielddata").used == 256


def test_track_token_charges_and_releases(iso):
    for _pkg, svc, reg, _arr in _both(iso):
        tok = reg.track(1 << 20, label="executor.data", tier="request")
        assert svc.breaker("request").used == 1 << 20
        assert reg.stats()["pinned"] == {"bytes": 1 << 20, "tokens": 1}
        tok.close()
        tok.close()  # idempotent
        assert svc.breaker("request").used == 0
        assert reg.stats()["pinned"] == {"bytes": 0, "tokens": 0}
    # the port's reserved form evicts to fit, then refuses
    _, (psvc, preg) = iso
    psvc.apply_cluster_settings({"indices.breaker.fielddata.limit": 300,
                                 "indices.breaker.fielddata.overhead": 1.0})
    h = preg.put_array(np.zeros(64, np.float32), label="h")
    tok = preg.track(200, label="pinned", reserve=True)
    assert not h.resident and psvc.breaker("fielddata").used == 200
    with pytest.raises(CircuitBreakingException):
        preg.track(200, label="more", reserve=True)
    tok.close()
    assert psvc.breaker("fielddata").used == 0


def test_a_collected_handle_gives_its_charge_back(iso):
    for _pkg, svc, reg, _arr in _both(iso):
        h = reg.put_array(np.zeros(64, np.float32), label="gc",
                          tier="fielddata")
        assert svc.breaker("fielddata").used == h.nbytes
        del h
        gc.collect()
        assert svc.breaker("fielddata").used == 0
        assert reg.stats()["tiers"]["fielddata"]["handles"] == 0


def test_close_releases_and_a_closed_handle_serves_uncharged(iso):
    """The port's deterministic release: ``close`` gives the charge back
    at once; a request still reading the handle gets a transient copy,
    charged to no one."""
    _, (psvc, preg) = iso
    host = np.arange(64, dtype=np.float32)
    h = preg.put_array(host, label="c")
    h.close()
    h.close()
    assert psvc.breaker("fielddata").used == 0
    assert preg.stats()["tiers"]["fielddata"]["handles"] == 0
    np.testing.assert_array_equal(h.get().numpy(), host)
    assert psvc.breaker("fielddata").used == 0 and not h.resident


def test_two_threads_rehydrating_one_handle(iso, monkeypatch):
    """Both threads reserve and place; the loser gives its reservation
    back and takes the winner's tensor: the breaker holds one copy."""
    _, (psvc, preg) = iso
    host = np.arange(1024, dtype=np.float32)
    h = preg.put_array(host, label="race")
    h.evict()
    orig = port_res.ResidentArray._place
    gate = threading.Barrier(2)

    def slow(self):
        t = orig(self)
        gate.wait(timeout=10)  # both placements done before either lands
        return t

    monkeypatch.setattr(port_res.ResidentArray, "_place", slow)
    out = [None, None]

    def run(i):
        out[i] = h.get()

    ts = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert out[0] is out[1]
    np.testing.assert_array_equal(out[0].numpy(), host)
    assert psvc.breaker("fielddata").used == h.nbytes
    st = preg.stats()["tiers"]["fielddata"]
    assert (st["rehydrations"], st["resident_bytes"]) == (1, h.nbytes)
    assert h.rehydrations == 1


def test_reserve_fault_point(iso):
    _, (psvc, preg) = iso
    FAULTS.inject("resources.reserve", CircuitBreakingException, count=1,
                  match=lambda c: c["label"] == "x")
    with pytest.raises(CircuitBreakingException):
        preg.put_array(np.zeros(8, np.float32), label="x")
    assert psvc.breaker("fielddata").used == 0
    assert preg.put_array(np.zeros(8, np.float32), label="x").resident


# -- PQ codes (tests/unit/test_pq.py) -----------------------------------------

def _pq_slab(n, dims, seed=0):
    x = clustered(n, dims, 16, seed=seed)
    D = 1 << int(np.ceil(np.log2(n)))
    vecs = np.zeros((D, dims), np.float32)
    vecs[:n] = x
    exists = np.zeros(D, bool)
    exists[:n] = True
    return torch.from_numpy(vecs), torch.from_numpy(exists)


def test_pq_codes_rehydrate_bit_equal(iso):
    from elasticsearch_tpu.ops import pq as ref_pq

    (_rsvc, rreg), (_psvc, preg) = iso
    tv, te = _pq_slab(2000, 16)
    seen = {}
    for pkg in ("ref", "port"):
        if pkg == "ref":
            pq = ref_pq.place_pq(ref_pq.build_pq(tv.numpy(), te.numpy(),
                                                 "cosine"), label="t")
            reg, arr = rreg, np.asarray
        else:
            pq = place_pq(build_pq(tv, te, "cosine"), preg, label="t")
            reg, arr = preg, (lambda t: t.numpy())
        before = arr(pq.codes_dev()).copy()
        assert pq.codes.resident
        assert reg.evict_all(tier="fielddata") == 1
        assert not pq.codes.resident
        after = arr(pq.codes_dev())
        assert pq.codes.resident
        np.testing.assert_array_equal(before, after)
        if pkg == "port":
            np.testing.assert_array_equal(after, pq.codes_host)
        st = dict(reg.stats()["tiers"]["fielddata"])
        st.pop("rehydrate_time_in_nanos")
        seen[pkg] = st
    assert seen["port"] == seen["ref"]


def test_pq_placement_is_best_effort(iso):
    from elasticsearch_tpu.ops import pq as ref_pq

    (rsvc, _rreg), (psvc, preg) = iso
    tv, te = _pq_slab(2000, 16)
    for svc in (rsvc, psvc):
        svc.apply_cluster_settings({"indices.breaker.fielddata.limit": 128})
    assert ref_pq.place_pq(ref_pq.build_pq(tv.numpy(), te.numpy(), "cosine"),
                           label="t") is None
    assert place_pq(build_pq(tv, te, "cosine"), preg, label="t") is None
    assert psvc.breaker("fielddata").used == 0


# -- nodes ------------------------------------------------------------------------

def _nodes(shards=1, mesh=False):
    body = {"settings": {"index": {"number_of_shards": shards,
                                   "search": {"mesh": mesh}}},
            "mappings": copy.deepcopy(MAPPING)}
    ref, port = RefNode(name="ref"), Node(name="port", device="cpu")
    for node in (ref, port):
        node.create_index("res", copy.deepcopy(body))
    return ref, port


def _breakers(node):
    return ref_resources.BREAKERS if isinstance(node, RefNode) \
        else node.breakers


def _registry(node):
    return ref_resources.RESIDENCY if isinstance(node, RefNode) \
        else node.residency


def _docs(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(str(i), {"body": " ".join(
        f"w{int(x)}" for x in rng.integers(0, 11, 10)),
        "n": int(rng.integers(-500, 500)) * 1_000_003,
        "tag": f"t{int(rng.integers(0, 5))}",
        "price": float(np.round(rng.random() * 100, 2))})
        for i in range(n)]


def _view(resp):
    return {"_shards": resp["_shards"], "total": resp["hits"]["total"],
            "hits": [(h["_id"], h.get("_score"), h.get("sort"))
                     for h in resp["hits"]["hits"]],
            "aggs": resp.get("aggregations")}


def _search(node, body):
    return node.search("res", copy.deepcopy(body))


def _failures(resp):
    """The failure entries without the node's id or the bytes a message
    quotes (packages lay out their columns alike, not their labels)."""
    return [(f["shard"], f["index"], f["status"], f["reason"]["type"])
            for f in resp["_shards"].get("failures", [])]


def _split_routing(n_shards=2):
    return [next(r for r in "abcdefgh" if shard_id_for("x", n_shards, r) == s)
            for s in range(n_shards)]


def test_chaos_reserve_point_gives_one_failure_entry(iso):
    ref, port = _nodes(shards=2)
    try:
        for node, faults, cbe in ((ref, REF_FAULTS, RefCBE),
                                  (port, FAULTS, CircuitBreakingException)):
            svc = node.indices["res"]
            for i in range(16):
                svc.index_doc(str(i), {"body": f"w{i}", "n": i})
            svc.refresh()
            faults.inject("resources.reserve", cbe, count=1)
        body = {"query": {"match_all": {}}, "sort": [{"n": "desc"}],
                "size": 20}
        got, want = _search(port, body), _search(ref, body)
        assert _failures(got) == _failures(want)
        assert len(_failures(got)) == 1 and got["_shards"] == dict(
            want["_shards"], failures=got["_shards"]["failures"])
        assert got["_shards"]["successful"] == 1
        assert got["_shards"]["failures"][0]["reason"]["type"] \
            == "circuit_breaking_exception"
        assert [h["_id"] for h in got["hits"]["hits"]] \
            == [h["_id"] for h in want["hits"]["hits"]]
        assert got["hits"]["hits"]
        # the point fired once: the next search is whole
        assert _view(_search(port, body)) == _view(_search(ref, body))
    finally:
        ref.close()
        port.close()


def test_fielddata_limit_partial_then_heal(iso):
    ref, port = _nodes(shards=2)
    r0, r1 = _split_routing()
    try:
        for node in (ref, port):
            svc = node.indices["res"]
            for i in range(8):  # shard 0 holds the column
                svc.index_doc(f"n{i}", {"body": "w", "n": i}, routing=r0)
            for i in range(8):  # shard 1 has none: it reserves nothing
                svc.index_doc(f"t{i}", {"body": "w"}, routing=r1)
            svc.refresh()
            _breakers(node).apply_cluster_settings(
                {"indices.breaker.fielddata.limit": 1})
        body = {"query": {"match_all": {}}, "sort": [{"n": "desc"}],
                "size": 20}
        got, want = _search(port, body), _search(ref, body)
        assert _failures(got) == _failures(want) == [
            (0, "res", 429, "circuit_breaking_exception")]
        assert got["_shards"]["failed"] == 1
        assert "[fielddata] Data too large" in \
            got["_shards"]["failures"][0]["reason"]["reason"]
        assert [h["_id"] for h in got["hits"]["hits"]] \
            == [h["_id"] for h in want["hits"]["hits"]] \
            and len(got["hits"]["hits"]) == 8
        br = port.nodes_stats()["nodes"][port.node_id]["breakers"]
        assert br["fielddata"]["tripped"] >= 1
        for node in (ref, port):
            _breakers(node).apply_cluster_settings({})
        got, want = _search(port, body), _search(ref, body)
        assert got["_shards"] == want["_shards"] == {
            "total": 2, "successful": 2, "failed": 0}
        assert _view(got) == _view(want) and len(got["hits"]["hits"]) == 16
        assert port.breakers.breaker("fielddata").used > 0
    finally:
        ref.close()
        port.close()


def test_all_shards_tripped_raises_429(iso):
    ref, port = _nodes(shards=1)
    try:
        for node in (ref, port):
            svc = node.indices["res"]
            for i in range(8):
                svc.index_doc(str(i), {"body": "w", "n": i})
            svc.refresh()
            _breakers(node).apply_cluster_settings(
                {"indices.breaker.fielddata.limit": 1})
        body = {"query": {"match_all": {}}, "sort": [{"n": "asc"}]}
        with pytest.raises(RefCBE) as want:
            _search(ref, body)
        with pytest.raises(CircuitBreakingException) as got:
            _search(port, body)
        assert got.value.status == want.value.status == 429
        assert str(got.value).startswith("all shards failed: [fielddata]")
        assert str(want.value).startswith("all shards failed: [fielddata]")
    finally:
        ref.close()
        port.close()


def test_the_mesh_route_reports_the_partial_answer_too(iso):
    """A rehydration the breaker denies on the mesh route sends the
    request to the host loop, which reports the shard's failure entry."""
    port = Node(name="port", device="cpu")
    try:
        port.create_index("m", {"settings": {"number_of_shards": 1},
                                "mappings": copy.deepcopy(MAPPING)})
        for doc_id, src in _docs(40):
            port.index("m", doc_id, src)
        port.refresh("m")
        body = {"query": {"match_all": {}}, "sort": [{"price": "asc"}]}
        want = port.search("m", copy.deepcopy(body))
        port.residency.evict_all()
        port.breakers.apply_cluster_settings(
            {"indices.breaker.fielddata.limit": 1})
        with pytest.raises(CircuitBreakingException,
                           match="all shards failed"):
            port.search("m", copy.deepcopy(body))
        port.breakers.apply_cluster_settings({})
        assert _view(port.search("m", copy.deepcopy(body))) == _view(want)
    finally:
        port.close()


def test_evict_rehydrate_parity_profile_and_span(iso):
    ref, port = _nodes(shards=1)
    try:
        for node in (ref, port):
            svc = node.indices["res"]
            for i in range(16):
                svc.index_doc(str(i), {"body": f"w{i}", "n": i * 3})
            svc.refresh()
        body = {"query": {"match_all": {}}, "sort": [{"n": "desc"}],
                "size": 16}
        first = {"ref": _search(ref, body), "port": _search(port, body)}
        for node in (ref, port):
            assert _registry(node).stats()["tiers"]["fielddata"]["loads"]
            assert _registry(node).evict_all() > 0
        again = {"ref": _search(ref, dict(body, profile=True)),
                 "port": _search(port, dict(body, profile=True))}
        for pkg in ("ref", "port"):
            assert [(h["_id"], h["sort"]) for h in first[pkg]["hits"]["hits"]] \
                == [(h["_id"], h["sort"])
                    for h in again[pkg]["hits"]["hits"]]
        assert [(h["_id"], h["sort"]) for h in again["port"]["hits"]["hits"]] \
            == [(h["_id"], h["sort"]) for h in again["ref"]["hits"]["hits"]]
        tpu = again["port"]["profile"]["shards"][0]["tpu"]["phases"]
        assert tpu["rehydrate_nanos"] > 0
        spans = [s for s in port.tracer.spans() if s.name == "tpu.rehydrate"]
        assert spans and all(s.tags["tier"] == "fielddata"
                             and s.tags["bytes"] > 0 for s in spans)
        assert {s.tags["label"] for s in spans} >= {"sort:n.key"}
        st = port.indices["res"].shards[0].stats()["fielddata"]
        assert st["evictions"] > 0 and st["rehydrations"] > 0
        ns = port.nodes_stats()["nodes"][port.node_id]
        assert ns["indices"]["fielddata"]["evictions"] > 0
        assert ns["indices"]["fielddata"]["rehydrations"] > 0
        assert ns["resources"]["tiers"]["fielddata"]["rehydrations"] > 0
        assert ns["tracing"]["finished_total"] >= len(spans)
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("mesh", [False, True])
def test_fielddata_stats_match_the_reference(iso, mesh):
    """The same writes and bodies: the ``fielddata`` section by field,
    and evictions and rehydrations over the columns, equal the
    reference's; evicted columns drop out of the map."""
    ref, port = _nodes(shards=2, mesh=mesh)
    try:
        for node in (ref, port):
            svc = node.indices["res"]
            for doc_id, src in _docs(60):
                svc.index_doc(doc_id, src)
            svc.refresh()
        bodies = [{"query": {"range": {"price": {"lt": 50}}}, "size": 5},
                  {"size": 0, "aggs": {"t": {"terms": {"field": "tag"}}}},
                  {"query": {"range": {"n": {"gte": 0}}}, "size": 5},
                  {"query": {"bool": {"filter": [
                      {"range": {"price": {"gte": 10}}},
                      {"term": {"tag": "t1"}}]}}, "size": 5}]

        def fd(node):
            return {str(k): v["fielddata"] for k, v in sorted(
                node.indices["res"].stats()["shards"].items())}

        assert fd(port) == fd(ref)  # nothing loaded yet
        for body in bodies:
            assert _view(_search(port, body)) == _view(_search(ref, body))
        assert fd(port) == fd(ref)
        for node in (ref, port):
            _registry(node).evict_all()
        assert fd(port) == fd(ref)
        for body in bodies[:2]:
            assert _view(_search(port, body)) == _view(_search(ref, body))
        got, want = fd(port), fd(ref)
        assert got == want
        # two shards on the mesh stack columns from their host mirrors:
        # nothing is placed there, so nothing evicts
        moved = (sum(v["evictions"] for v in got.values()),
                 sum(v["rehydrations"] for v in got.values()))
        assert (moved == (0, 0)) if mesh else min(moved) > 0
    finally:
        ref.close()
        port.close()


def test_dense_block_evicts_and_its_denial_keeps_the_scatter_path(
        iso, monkeypatch):
    for mod in (ref_segmod, port_segmod):
        monkeypatch.setattr(mod, "build_dense_impact", functools.partial(
            mod.build_dense_impact, df_threshold=2))
    ref, port = _nodes(shards=1)
    try:
        for node in (ref, port):
            svc = node.indices["res"]
            for i in range(48):
                svc.index_doc(str(i), {"body": " ".join(
                    f"w{(i * 7 + j * 3) % 11}" for j in range(10))})
            svc.refresh()
        body = {"query": {"match": {"body": "w1 w4"}}, "size": 10}
        first = {n: _search(node, body) for n, node in
                 (("ref", ref), ("port", port))}
        for node in (ref, port):
            seg = node.indices["res"].shards[0].segments[0]
            assert seg.inverted["body"].dense_block() is not None
            _registry(node).evict_all()
        again = {n: _search(node, body) for n, node in
                 (("ref", ref), ("port", port))}
        for pkg in ("ref", "port"):
            assert [(h["_id"], h["_score"]) for h in first[pkg]["hits"]["hits"]] \
                == [(h["_id"], h["_score"])
                    for h in again[pkg]["hits"]["hits"]]
        seg = port.indices["res"].shards[0].segments[0]
        ev, rh = seg.fielddata_evictions()
        assert ev > 0 and rh > 0
        # a denied rehydration: the scatter path answers, no 429
        for node in (ref, port):
            _registry(node).evict_all()
            _breakers(node).apply_cluster_settings(
                {"indices.breaker.fielddata.limit": 1})
        got, want = _search(port, body), _search(ref, body)
        assert got["_shards"]["failed"] == want["_shards"]["failed"] == 0
        assert [h["_id"] for h in got["hits"]["hits"]] \
            == [h["_id"] for h in want["hits"]["hits"]] \
            == [h["_id"] for h in first["port"]["hits"]["hits"]]
    finally:
        ref.close()
        port.close()


def test_breakers_return_to_the_start_after_a_merge_and_a_close(iso):
    port = Node(name="port", device="cpu")
    start = {n: port.breakers.breaker(n).used
             for n in ("segments", "fielddata")}
    try:
        port.create_index("res", {"settings": {"number_of_shards": 1},
                                  "mappings": copy.deepcopy(MAPPING)})
        docs = _docs(120)
        for a in range(0, 120, 30):
            for doc_id, src in docs[a: a + 30]:
                port.index("res", doc_id, src)
            port.refresh("res")
        bodies = [{"query": {"match_phrase": {"body": "w1 w2"}},
                   "sort": [{"n": "asc"}], "size": 5},
                  {"size": 0, "aggs": {"t": {"terms": {"field": "tag"}}}}]
        for body in bodies:
            port.search("res", copy.deepcopy(body))
        svc = port.indices["res"]
        fd = port.breakers.breaker("fielddata")
        ex = svc._mesh_executor

        def held():
            segs = [s for sh in svc.shards for s in sh.segments]
            caches = 0 if ex is None else ex.data_bytes() + sum(
                rd.nbytes for rd in ex._prep.values())
            return sum(s.fielddata_bytes() for s in segs) + caches

        retired = list(svc.shards[0].segments)
        assert len(retired) == 4 and fd.used == held() > 0
        svc.force_merge(1)
        assert all(s.fielddata_bytes() == 0 for s in retired)
        assert fd.used == held()
        for body in bodies:
            port.search("res", copy.deepcopy(body))
        assert fd.used == held() > 0
    finally:
        port.close()
    assert {n: port.breakers.breaker(n).used
            for n in ("segments", "fielddata")} == start
    assert port.residency.stats()["pinned"] == {"bytes": 0, "tokens": 0}
    assert port.residency.stats()["tiers"]["fielddata"]["resident_bytes"] \
        == 0


def test_columns_load_on_first_touch_and_stacking_reads_host_mirrors(iso):
    """Freeze charges no fielddata; a mesh round over two shards stacks
    the columns from their host mirrors (nothing placed, nothing
    rehydrated), and the host loop places them on first touch."""
    port = Node(name="port", device="cpu")
    try:
        port.create_index("res", {"settings": {"number_of_shards": 2},
                                  "mappings": copy.deepcopy(MAPPING)})
        for doc_id, src in _docs(60):
            port.index("res", doc_id, src)
        port.refresh("res")
        reg = port.residency
        assert reg.stats()["tiers"]["fielddata"]["loads"] == 0
        body = {"query": {"range": {"price": {"lt": 50}}}, "size": 5}
        port.search("res", copy.deepcopy(body))
        assert reg.stats()["tiers"]["fielddata"]["loads"] == 0
        svc = port.indices["res"]
        assert svc.mesh_executor().data_bytes() > 0
        port.search("res", dict(body, profile=True))  # the host loop
        st = reg.stats()["tiers"]["fielddata"]
        assert st["loads"] == 2 * 2  # values and exists, on each shard
        assert st["rehydrations"] == 0
    finally:
        port.close()
