"""The port's observability surface against the JAX package on the CPU:
the span tracer (``tracing/tracer.py``), the index slow logs
(``tracing/slowlog.py``), the node-level sections of ``nodes_stats``
(``monitor/stats.py``) and ``Node.info``.

The tracer and the slow logs run the reference's unit scenarios
(``tests/unit/test_observability.py``) on both packages; the stats
sections' keys are held against the reference's ``nodes_stats``, and
``device_stats`` reports ``cpu`` on a node asked for the CPU without
probing for a card.
"""
import copy
import logging

import pytest
import torch

from elasticsearch_tpu.index.index_service import \
    IndexService as RefIndexService
from elasticsearch_tpu.monitor import stats as ref_stats
from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu.tracing import tracer as ref_tracer
from elasticsearch_tpu_torch import Node
from elasticsearch_tpu_torch.index.index_service import IndexService
from elasticsearch_tpu_torch.monitor import stats
from elasticsearch_tpu_torch.resources.residency import Residency
from elasticsearch_tpu_torch.tracing import tracer
from elasticsearch_tpu_torch.tracing.slowlog import parse_time_millis

PACKAGES = [pytest.param(ref_tracer, id="ref"),
            pytest.param(tracer, id="port")]


# -- the tracer ------------------------------------------------------------------

@pytest.mark.parametrize("mod", PACKAGES)
def test_nested_spans_share_a_trace_and_link_parents(mod):
    tr = mod.Tracer("n1")
    with tr.span("outer") as outer:
        with tr.span("inner") as inner:
            pass
    assert inner.trace_id == outer.trace_id
    assert inner.parent_id == outer.span_id and outer.parent_id is None
    assert [s.name for s in tr.spans()] == ["inner", "outer"]
    assert all(s.duration >= 0 for s in tr.spans())
    with tr.span("a"):
        pass
    with tr.span("b"):
        pass
    a, b = tr.spans()[-2:]
    assert a.trace_id != b.trace_id


@pytest.mark.parametrize("mod", PACKAGES)
def test_an_error_is_recorded_and_raised(mod):
    tr = mod.Tracer("n1")
    with pytest.raises(ValueError):
        with tr.span("boom"):
            raise ValueError("nope")
    assert tr.spans()[0].error == "ValueError: nope"


def test_ring_counters_and_chrome_trace_match_the_reference():
    got = {}
    for name, mod in (("ref", ref_tracer), ("port", tracer)):
        tr = mod.Tracer("n1", max_spans=4)
        for i in range(10):
            with tr.span(f"s{i}", index="idx", n=i):
                pass
        dump = tr.chrome_trace()
        ev = dump["traceEvents"][-1]
        assert ev["ph"] == "X" and ev["dur"] >= 1
        assert ev["args"]["trace_id"] and ev["args"]["index"] == "idx"
        got[name] = (tr.stats(), [s.name for s in tr.spans()],
                     sorted(ev), sorted(ev["args"]), dump["otherData"],
                     sorted(tr.spans()[0].to_json()))
    assert got["port"] == got["ref"]
    assert got["port"][0] == {"started_total": 10, "finished_total": 10,
                              "retained": 4}


@pytest.mark.parametrize("mod", PACKAGES)
def test_an_adopted_header_joins_the_remote_trace(mod):
    tr = mod.Tracer("n1")
    with mod.adopt({"trace_id": "t" * 16, "span_id": "p" * 16}):
        with tr.span("child"):
            assert mod.trace_header()["trace_id"] == "t" * 16
    sp = tr.spans()[0]
    assert (sp.trace_id, sp.parent_id) == ("t" * 16, "p" * 16)
    assert mod.trace_header() is None
    groups = mod.find_trace_ids(tr.spans())
    assert list(groups) == ["t" * 16]


# -- slow logs ---------------------------------------------------------------------

def _services(name, settings):
    ref = RefIndexService(name, settings=copy.deepcopy(settings))
    port = IndexService(name, Residency(torch.device("cpu")),
                        settings=copy.deepcopy(settings))
    return ref, port


def _entries(log):
    return [{k: v for k, v in e.items() if k != "took_millis"}
            for e in log["entries"]]


@pytest.mark.parametrize("value,want", [
    ("500ms", 500.0), ("1s", 1000.0), ("2m", 120000.0), ("250", 250.0),
    ("1500micros", 1.5), (-1, None), ("-1", None), (None, None),
    ("soon", None)])
def test_threshold_grammar_matches_the_reference(value, want):
    from elasticsearch_tpu.tracing.slowlog import \
        parse_time_millis as ref_parse

    assert parse_time_millis(value) == ref_parse(value) == want


def test_a_search_threshold_records_as_the_reference():
    settings = {"index": {"number_of_shards": 1, "search": {"slowlog": {
        "threshold": {"query": {"warn": "0ms"}}}}}}
    ref, port = _services("slow", settings)
    try:
        logs = []
        for svc in (ref, port):
            svc.index_doc("1", {"t": "hello"})
            svc.refresh()
            svc.search({"query": {"match_all": {}}})
            logs.append(svc.slowlog.query.to_json())
        want, got = logs
        assert got["total"] == want["total"] == 1
        assert _entries(got) == _entries(want)
        entry = got["entries"][0]
        assert entry["level"] == "warn" and entry["index"] == "slow"
        assert "match_all" in entry["source"]
        assert port.slowlog.index.to_json()["total"] == 0
    finally:
        ref.close()
        port.close()


def test_no_thresholds_no_entries():
    ref, port = _services("quiet", {"index": {"number_of_shards": 1}})
    try:
        for svc in (ref, port):
            svc.index_doc("1", {"t": "x"})
            svc.refresh()
            svc.search({"query": {"match_all": {}}})
            assert svc.slowlog.stats() == {
                "search": {"total": 0, "entries": []},
                "indexing": {"total": 0, "entries": []}}
    finally:
        ref.close()
        port.close()


def test_the_indexing_slowlog_and_the_node_totals(caplog):
    settings = {"index": {"number_of_shards": 1,
                          "indexing.slowlog.threshold.index.info": "0ms"}}
    ref, port = _services("wslow", settings)
    rq, pq = _services("wquiet", {"index": {"number_of_shards": 1}})
    try:
        with caplog.at_level(logging.INFO, logger="index.indexing.slowlog"):
            for svc, quiet in ((ref, rq), (port, pq)):
                svc.index_doc("1", {"t": "x"})
                quiet.index_doc("1", {"t": "x"})
        assert [r.levelname for r in caplog.records] == ["INFO", "INFO"]
        got, want = port.slowlog.index.to_json(), ref.slowlog.index.to_json()
        assert _entries(got) == _entries(want) == [
            {"index": "wslow", "level": "info", "op": "index", "id": "1"}]
        assert stats.aggregate_slowlog([port, pq]) \
            == ref_stats.aggregate_slowlog([ref, rq]) \
            == {"search_slow_total": 0, "indexing_slow_total": 1}
        assert stats.aggregate_slowlog([pq]) == {
            "search_slow_total": 0, "indexing_slow_total": 0}
    finally:
        for svc in (ref, port, rq, pq):
            svc.close()


def test_a_settings_update_applies_at_once():
    from elasticsearch_tpu.cluster.metadata import \
        update_index_settings as ref_update

    ref = RefNode(name="ref")
    port = Node(name="port", device="cpu")
    try:
        for node in (ref, port):
            node.create_index("dyn", {"settings": {"number_of_shards": 1}})
            node.indices["dyn"].index_doc("1", {"t": "x"})
            node.indices["dyn"].refresh()
            node.search("dyn", {"query": {"match_all": {}}})
        ref_update(ref.indices["dyn"], {
            "index.search.slowlog.threshold.query.trace": "0ms"}, node=ref)
        port.update_index_settings("dyn", {
            "index.search.slowlog.threshold.query.trace": "0ms"})
        for node in (ref, port):
            node.search("dyn", {"query": {"match_all": {}}})
        got = port.indices["dyn"].slowlog.query.to_json()
        want = ref.indices["dyn"].slowlog.query.to_json()
        assert got["total"] == want["total"] == 1
        assert _entries(got) == _entries(want)
        ns = port.nodes_stats()["nodes"][port.node_id]
        assert ns["slowlog"] == {"search_slow_total": 1,
                                 "indexing_slow_total": 0}
    finally:
        ref.close()
        port.close()


# -- nodes_stats, info -------------------------------------------------------------

SECTIONS = ("process", "os", "jvm", "resources", "tracing", "slowlog")


def _keys(d, depth=3):
    """The nested key structure of a stats section."""
    if not isinstance(d, dict) or depth == 0:
        return None
    return {k: _keys(v, depth - 1) for k, v in d.items()}


def test_node_sections_carry_the_references_keys():
    ref = RefNode(name="ref")
    port = Node(name="port", device="cpu")
    try:
        for node in (ref, port):
            node.create_index("s", {"mappings": {"properties": {
                "n": {"type": "long"}}}})
            for i in range(8):
                node.indices["s"].index_doc(str(i), {"n": i})
            node.indices["s"].refresh()
            node.search("s", {"sort": [{"n": "asc"}]})
        want = ref.nodes_stats()["nodes"][ref.node_id]
        got = port.nodes_stats()["nodes"][port.node_id]
        for sec in SECTIONS:
            assert _keys(got[sec]) == _keys(want[sec]), sec
        assert set(got["indices"]["fielddata"]) == {
            "memory_size_in_bytes", "evictions", "rehydrations"}
        assert set(want["indices"]["fielddata"]) < set(
            got["indices"]["fielddata"])
        # the REST layer's sections (ROADMAP A10e), the flight
        # recorder's, the watchdog's and the compile/warm layer's
        assert got["thread_pool"] == want["thread_pool"] == {}
        assert _keys(got["flight"]) == _keys(want["flight"])
        assert _keys(got["watchdog"]) == _keys(want["watchdog"])
        assert _keys(got["tasks"]) == _keys(want["tasks"])
        # the families of each node's own registry (the process-shared
        # ones depend on what else the process ran)
        own = {"estpu_indexing_duration_seconds",
               "estpu_indexing_operations_total",
               "estpu_search_duration_seconds", "estpu_span_duration_seconds",
               "estpu_coalescer_batch_size",
               "estpu_coalescer_queue_wait_seconds"}
        assert own <= set(got["metrics"]) and own <= set(want["metrics"])
        for fam in own:
            assert [_keys(x) for x in got["metrics"][fam]] == \
                [_keys(x) for x in want["metrics"][fam]], fam
        assert set(want["serving"]) == set(got["serving"])
        assert _keys(got["serving"]["qos"]) == _keys(want["serving"]["qos"])
        assert _keys(got["serving"]["warmup"]) == \
            _keys(want["serving"]["warmup"])
        assert _keys(got["programs"]) == _keys(want["programs"])
        assert got["programs"]["keys"] > 0
        assert got["transport"] == want["transport"]
        assert got["accelerator"] == {"platform": "cpu"}
        assert got["jvm"]["mem"]["heap_used_in_bytes"] \
            == got["process"]["mem"]["resident_in_bytes"] > 0
        assert got["resources"]["tiers"]["fielddata"]["loads"] > 0
        assert _keys(port.info()) == _keys(ref.info())
        assert port.info()["devices"] == ["cpu"]
    finally:
        ref.close()
        port.close()


def test_device_stats_on_the_cpu_never_probe_a_card(monkeypatch):
    def no_card(*a, **kw):
        raise AssertionError("probed the card")

    for name in ("mem_get_info", "get_device_name", "memory_allocated",
                 "memory_reserved", "is_available"):
        monkeypatch.setattr(torch.cuda, name, no_card)
    assert stats.device_stats(torch.device("cpu")) == {"platform": "cpu"}
    assert stats.device_stats("cpu") == {"platform": "cpu"}


def test_process_and_os_sections_match_the_reference_shape():
    assert _keys(stats.process_stats()) == _keys(ref_stats.process_stats())
    assert _keys(stats.os_stats()) == _keys(ref_stats.os_stats())


def test_process_counters_and_delta_match_the_reference():
    """The bench snapshot (``monitor/metrics.py::process_counters``) and
    its delta on both packages: a kernel record and a SHARED counter move
    it alike; the port reads its node's breaker trips where the
    reference reads its process's (ROADMAP C20)."""
    from elasticsearch_tpu.monitor import kernels as ref_kernels
    from elasticsearch_tpu.monitor import metrics as ref_metrics
    from elasticsearch_tpu_torch.monitor import kernels, metrics

    port = Node(name="port", device="cpu")
    try:
        deltas, node_keys = [], []
        for mod, kmod, args in ((ref_metrics, ref_kernels, ()),
                                (metrics, kernels, (port,))):
            before = mod.process_counters(*args)
            kmod.record("executor_prep_hit")
            kmod.record("executor_prep_miss", 2)
            mod.SHARED.counter("estpu_test_delta_total", "t").inc(3)
            d = mod.counters_delta(before, mod.process_counters(*args))
            node_keys.append({k for k in d
                              if k.startswith(("breakers.", "residency."))})
            deltas.append({k: d[k] for k in (
                "kernels.executor_prep_hit", "kernels.executor_prep_miss",
                "estpu_test_delta_total")})
            assert mod.counters_delta({"a": -1.0}, {"a": 5.0}) == {"a": None}
        assert node_keys[0] == node_keys[1]
        assert "breakers.in_flight_requests.tripped" in node_keys[1]
        assert deltas[0] == deltas[1] == {
            "kernels.executor_prep_hit": 1, "kernels.executor_prep_miss": 2,
            "estpu_test_delta_total": 3}
    finally:
        port.close()
