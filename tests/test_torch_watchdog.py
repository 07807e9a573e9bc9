"""The port's flight recorder and stall watchdog (``monitor/flight.py``,
``monitor/watchdog.py``, the in-flight half of ``monitor/programs.py``)
against the reference's, on the classes of the reference's
``tests/unit/test_watchdog.py``.

Each scenario runs on one node of each package, with its own fresh
recorder and watchdog: both packages' recorders are process-wide fans,
and the tests run several nodes in one process. The port's breakers
belong to their node (ROADMAP C20), so a breaker trip lands in its own
node's ring, where the reference's lands in every ring of the process
(ROADMAP C29, held here). The cluster scenario runs a trio of each
package (``tests/_torch_cluster.py``).
"""
import re
import threading
import time
from types import SimpleNamespace

import pytest

from _torch_cluster import PACKAGES as CLUSTER_PACKAGES
from _torch_cluster import Trio
from elasticsearch_tpu.monitor import flight as ref_flight
from elasticsearch_tpu.monitor import programs as ref_programs
from elasticsearch_tpu.monitor import watchdog as ref_watchdog
from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu.rest.server import RestController as RefController
from elasticsearch_tpu.utils.faults import FAULTS as REF_FAULTS
from elasticsearch_tpu_torch.monitor import flight, programs, watchdog
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.rest.server import RestController
from elasticsearch_tpu_torch.utils.faults import FAULTS

REF = SimpleNamespace(name="ref", flight=ref_flight, programs=ref_programs,
                      watchdog=ref_watchdog, faults=REF_FAULTS,
                      node=lambda **kw: RefNode(**kw),
                      controller=RefController)
PORT = SimpleNamespace(name="port", flight=flight, programs=programs,
                       watchdog=watchdog, faults=FAULTS,
                       node=lambda **kw: Node(device="cpu", **kw),
                       controller=RestController)
BOTH = (REF, PORT)
IDS = ("ref", "port")

#: the diagnostics bundle's schema (support tooling parses it)
BUNDLE_KEYS = {"version", "cluster_name", "timestamp", "master_node",
               "_nodes", "nodes", "failures"}
NODE_KEYS = {"name", "flight", "watchdog", "incidents",
             "incident_payloads", "hot_threads", "tasks", "programs",
             "breakers", "thread_pool"}


@pytest.fixture(autouse=True)
def _clean_faults():
    for pkg in BOTH:
        pkg.faults.clear()
    yield
    for pkg in BOTH:
        pkg.faults.clear()


@pytest.fixture(params=BOTH, ids=IDS)
def pkg(request):
    return request.param


@pytest.fixture()
def node(pkg):
    n = pkg.node(name="wd-node")
    yield n
    n.close()


def _trips(wd, detector):
    return [t for t in wd.run_once() if t["detector"] == detector]


# -- the flight recorder ---------------------------------------------------

class TestFlightRecorder:
    def test_ring_capacities_are_the_references(self):
        assert flight.RING_CAPS == ref_flight.RING_CAPS

    def test_rings_are_bounded_counts_exact(self, pkg):
        rec = pkg.flight.FlightRecorder("n1", "one")
        cap = pkg.flight.RING_CAPS["trips"]
        for i in range(cap * 2):
            rec.record("trips", seq=i)
        snap = rec.snapshot()
        assert len(snap["rings"]["trips"]) == cap
        assert snap["counts"]["trips"] == cap * 2
        assert snap["rings"]["trips"][-1]["seq"] == cap * 2 - 1
        assert snap["ring_caps"] == pkg.flight.RING_CAPS
        assert rec.stats()["retained"]["trips"] == cap

    def test_unknown_ring_raises(self, pkg):
        with pytest.raises(KeyError):
            pkg.flight.FlightRecorder().record("not_a_ring", x=1)

    def test_entries_are_monotonic_stamped_and_trace_linked(self, node):
        with node.tracer.span("outer") as sp:
            node.flight.record("slow_ops", detector="t")
        e = node.flight.ring("slow_ops")[-1]
        assert e["ts_monotonic"] > 0 and e["timestamp_ms"] > 0
        assert e["trace_id"] == sp.trace_id
        assert node.flight.events_since("slow_ops", e["ts_monotonic"]) == []

    def test_process_fan_reaches_every_registered_recorder(self, pkg):
        a = pkg.flight.FlightRecorder("a")
        b = pkg.flight.FlightRecorder("b")
        pkg.flight.register(a)
        pkg.flight.register(b)
        try:
            pkg.flight.record("engine_failures", index="i", reason="r")
            assert a.ring("engine_failures")[-1]["index"] == "i"
            assert b.ring("engine_failures")[-1]["index"] == "i"
        finally:
            pkg.flight.unregister(a)
            pkg.flight.unregister(b)
        pkg.flight.record("engine_failures", index="j", reason="r")
        assert a.ring("engine_failures")[-1]["index"] == "i"

    def test_engine_failure_lands_in_ring(self, node):
        node.create_index("ef", {"settings": {"number_of_shards": 1}})
        node.indices["ef"].groups[0].copies[0].engine.fail("injected boom")
        assert any(e["index"] == "ef" and "boom" in e["reason"]
                   for e in node.flight.ring("engine_failures"))

    def test_c29_a_breaker_trip_lands_in_its_own_nodes_ring(self):
        """ROADMAP C29: the reference's breakers are process-wide and a
        trip fans to every recorder of the process; the port's breakers
        belong to their node, and a trip lands in that node's ring
        alone. The entry's keys are the reference's."""
        from elasticsearch_tpu import resources
        from elasticsearch_tpu.utils.errors import \
            CircuitBreakingException as RefBreaking
        from elasticsearch_tpu_torch.utils.errors import \
            CircuitBreakingException

        r1, r2 = RefNode(name="r1"), RefNode(name="r2")
        p1, p2 = Node(name="p1", device="cpu"), Node(name="p2", device="cpu")
        try:
            with pytest.raises(RefBreaking):
                resources.BREAKERS.breaker("request").break_or_reserve(
                    1 << 62, "<test>")
            with pytest.raises(CircuitBreakingException):
                p1.breakers.breaker("request").break_or_reserve(
                    1 << 62, "<test>")
            rr = [n.flight.ring("breaker_trips") for n in (r1, r2)]
            pr = [n.flight.ring("breaker_trips") for n in (p1, p2)]
            assert all(any(e["breaker"] == "request" for e in ring)
                       for ring in rr)
            assert any(e["breaker"] == "request" for e in pr[0])
            assert pr[1] == []
            strip = {"ts_monotonic", "timestamp_ms", "trace_id"}
            assert set(pr[0][-1]) - strip == set(rr[0][-1]) - strip
            assert pr[0][-1]["parent"] == rr[0][-1]["parent"] is False
        finally:
            for n in (r1, r2, p1, p2):
                n.close()


# -- the program-stall detector --------------------------------------------

class TestProgramStallDetector:
    def test_inflight_past_bound_trips_with_offending_key(self, pkg, node):
        wd = pkg.watchdog.WatchdogService(node, program_default_bound_s=0.0,
                                          cooldown_s=0.0)
        tok = pkg.programs.REGISTRY.begin_dispatch("mesh_dsl", "S=1|D=64")
        try:
            trips = _trips(wd, "program_stall")
        finally:
            pkg.programs.REGISTRY.end_dispatch(tok)
        mine = [t for t in trips if t["detail"]["program"] == "mesh_dsl"]
        assert mine, "an aged dispatch in flight must trip"
        d = mine[0]["detail"]
        assert d["shapes"] == "S=1|D=64" and not d["injected"]
        assert d["bound_seconds"] == 0.0
        assert mine[0]["incident_id"]

    def test_below_the_bound_records_a_slow_op(self, pkg, node):
        wd = pkg.watchdog.WatchdogService(node, program_default_bound_s=0.2,
                                          cooldown_s=0.0)
        tok = pkg.programs.REGISTRY.begin_dispatch("k_slow", "Q=1")
        try:
            time.sleep(0.12)
            assert _trips(wd, "program_stall") == []
        finally:
            pkg.programs.REGISTRY.end_dispatch(tok)
        assert any(e.get("program") == "k_slow"
                   for e in node.flight.ring("slow_ops"))

    def test_adaptive_bound_derives_from_key_p99(self, pkg, node):
        wd = pkg.watchdog.WatchdogService(node, program_floor_s=0.0,
                                          program_p99_mult=4.0,
                                          program_min_calls=4)
        key = (f"k_adapt_{pkg.name}", "Q=4")
        for _ in range(8):
            pkg.programs.REGISTRY.record_execute(*key, 0.002)
        bound = wd._program_bound(*key)
        p99, calls = pkg.programs.REGISTRY.execute_p99(*key)
        assert calls == 8
        assert bound == pytest.approx(4.0 * p99)
        assert bound < wd.config["program_default_bound_s"]
        assert wd._program_bound("k_unknown", "Q=4") == \
            wd.config["program_default_bound_s"]

    def test_the_p99_of_the_same_history_is_the_references(self):
        for i, s in enumerate((0.0003, 0.002, 0.0021, 0.05, 0.7, 3.0)):
            for pkg in BOTH:
                pkg.programs.REGISTRY.record_execute("k_same", "Q=1", s)
        assert programs.REGISTRY.execute_p99("k_same", "Q=1") == \
            ref_programs.REGISTRY.execute_p99("k_same", "Q=1")

    def test_timed_brackets_the_dispatch(self):
        """A dispatch is in flight inside ``timed``; once the block
        returns, the key's first dispatch in the process is recorded as
        a compile (it paid the first touch) and each later one as an
        execute; a raising block records nothing."""
        key = (f"k_timed_{time.monotonic_ns()}", "Q=2")
        for _ in range(2):
            with programs.REGISTRY.timed(*key):
                rows = [r for r in programs.REGISTRY.inflight_snapshot()
                        if r["program"] == key[0]]
                assert rows and rows[0]["shapes"] == "Q=2"
                time.sleep(0.01)
        assert not [r for r in programs.REGISTRY.inflight_snapshot()
                    if r["program"] == key[0]]
        p99, calls = programs.REGISTRY.execute_p99(*key)
        assert calls == 1 and p99 >= 0.01
        with pytest.raises(RuntimeError):
            with programs.REGISTRY.timed(*key):
                raise RuntimeError("failed dispatch")
        assert programs.REGISTRY.execute_p99(*key)[1] == 1
        row = [r for r in programs.REGISTRY.snapshot()
               if r["program"] == key[0]][0]
        assert row["calls"] == 1 and row["execute_seconds"] >= 0.01
        assert row["compiles"] == 1 and row["compile_seconds"] >= 0.01

    def test_a_search_dispatch_is_in_flight_until_its_result_is_read(self):
        """The port's mesh round stays in flight up to its copy back: a
        stall inside it is seen by the detector from another thread."""
        from elasticsearch_tpu_torch.parallel import executor

        n = Node(name="inflight", device="cpu")
        seen, gate, release = [], threading.Event(), threading.Event()
        real = executor.MeshSearchExecutor._run_round

        def slow_round(self, rd):
            gate.set()
            release.wait(10)
            return real(self, rd)

        try:
            n.create_index("s", {"settings": {"number_of_shards": 1}})
            n.indices["s"].index_doc("1", {"body": "quick fox"})
            n.indices["s"].refresh()
            wd = watchdog.WatchdogService(n, program_default_bound_s=0.0,
                                          cooldown_s=0.0)
            executor.MeshSearchExecutor._run_round = slow_round
            th = threading.Thread(target=lambda: seen.append(n.search(
                "s", {"query": {"match": {"body": "fox"}}})))
            th.start()
            assert gate.wait(30)
            trips = [t for t in _trips(wd, "program_stall")
                     if t["detail"]["program"] == "mesh_dsl"]
            release.set()
            th.join(30)
        finally:
            executor.MeshSearchExecutor._run_round = real
            release.set()
            n.close()
        assert trips and trips[0]["detail"]["shapes"].startswith("D=")
        assert seen and seen[0]["hits"]["total"] == 1

    def test_injected_fault_trips_and_incident_is_retrievable(self, pkg,
                                                              node):
        wd = node.watchdog
        tok = pkg.programs.REGISTRY.begin_dispatch("mesh_bm25", "Q=16")
        pkg.faults.inject("watchdog.program_stall", count=1)
        try:
            trips = _trips(wd, "program_stall")
        finally:
            pkg.programs.REGISTRY.end_dispatch(tok)
        assert trips and trips[0]["detail"]["injected"]
        iid = trips[0]["incident_id"]
        inc = wd.incidents.load(iid)
        assert inc is not None
        assert set(inc["flight"]["rings"]) == set(pkg.flight.RING_CAPS)
        assert inc["hot_threads"]
        assert any(r["program"] == "mesh_bm25"
                   for r in inc["programs"]["inflight"])
        assert 'estpu_watchdog_trips_total{detector="program_stall"}' \
            in node.metrics.expose()
        assert wd.stats()["trips"]["program_stall"] >= 1
        assert pkg.faults.fired("watchdog.program_stall") == 1

    def test_incident_keys_are_the_references(self):
        """The dump's keys are the reference's; its ``programs`` section
        holds the totals, the dispatches in flight and each key's row,
        compiles beside execute counters, as the reference's does."""
        incs = []
        for pkg in BOTH:
            n = pkg.node(name="inc")
            try:
                pkg.faults.inject("watchdog.program_stall", count=1)
                iid = _trips(n.watchdog, "program_stall")[0]["incident_id"]
                incs.append(n.watchdog.incidents.load(iid))
            finally:
                n.close()
        ref, port = incs
        assert set(port) == set(ref)
        assert set(port["programs"]) == set(ref["programs"]) == {
            "totals", "inflight", "table"}
        assert set(port["programs"]["totals"]) == \
            set(ref["programs"]["totals"])
        for row in port["programs"]["table"]:
            assert set(row) == set(ref_programs.ProgramEntry(
                "p", "s", "b").to_json())
        assert port["detail"] == ref["detail"]
        assert port["reason"] == ref["reason"]

    def test_cooldown_debounces_incident_capture(self, pkg, node):
        wd = pkg.watchdog.WatchdogService(node, cooldown_s=3600.0)
        pkg.faults.inject("watchdog.program_stall", count=2)
        t1 = _trips(wd, "program_stall")[0]
        t2 = _trips(wd, "program_stall")[0]
        assert t1["incident_id"] is not None
        assert t2["incident_id"] is None  # counted, recorded, not dumped
        assert wd.stats()["trips"]["program_stall"] == 2
        assert wd.stats()["incidents_captured"] == 1
        assert node.flight.stats()["counts"]["trips"] == 2

    def test_unknown_option_is_refused(self, pkg, node):
        with pytest.raises(ValueError, match="unknown watchdog option"):
            pkg.watchdog.WatchdogService(node, no_such_bound_s=1.0)
        assert set(watchdog.DETECTORS) == set(ref_watchdog.DETECTORS)
        assert watchdog.WatchdogService.DEFAULTS == \
            ref_watchdog.WatchdogService.DEFAULTS


# -- the other five detectors ----------------------------------------------

class TestOtherDetectors:
    def test_threadpool_starvation_needs_old_head_and_busy_workers(
            self, pkg, node):
        if pkg is REF:
            from elasticsearch_tpu.utils.threadpool import FixedThreadPool
        else:
            from elasticsearch_tpu_torch.utils.threadpool import \
                FixedThreadPool
        pool = FixedThreadPool("stall", size=1, queue_size=4)
        release = threading.Event()
        threading.Thread(target=pool.execute, args=(release.wait,),
                         daemon=True).start()
        threading.Thread(target=pool.execute, args=(lambda: None,),
                         daemon=True).start()
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if pool.stats()["queue"] >= 1 and pool.stats()["active"] >= 1:
                break
            time.sleep(0.01)
        assert pool.oldest_queue_age() is not None
        wd = pkg.watchdog.WatchdogService(node, threadpool_age_bound_s=0.0,
                                          cooldown_s=0.0)
        saved = node._thread_pool
        node._thread_pool = SimpleNamespace(pools={"stall": pool})
        try:
            trips = _trips(wd, "threadpool_starve")
        finally:
            node._thread_pool = saved
            release.set()
            pool.shutdown()
        assert trips and trips[0]["detail"]["pool"] == "stall"
        assert set(trips[0]["detail"]) == {"pool", "oldest_age_seconds",
                                           "active", "threads", "queue"}

    def test_fsync_latency_over_bound_trips(self, pkg, node):
        if pkg is REF:
            from elasticsearch_tpu.monitor.metrics import SHARED
        else:
            from elasticsearch_tpu_torch.monitor.metrics import SHARED
        wd = pkg.watchdog.WatchdogService(node, fsync_bound_s=1.0,
                                          cooldown_s=0.0)
        wd.run_once()  # the cursor passes earlier syncs of the process
        SHARED.histogram("estpu_translog_fsync_duration_seconds",
                         "Translog flush+fsync latency").observe(5.0)
        trips = _trips(wd, "translog_fsync")
        assert trips and trips[0]["detail"]["avg_seconds"] >= 1.0
        assert trips[0]["detail"]["window_max_at_least_seconds"] >= 1.0

    def test_coalescer_drain_age_trips(self, pkg, node):
        if pkg is REF:
            from elasticsearch_tpu.serving.coalescer import _Entry
        else:
            from elasticsearch_tpu_torch.serving.coalescer import _Entry
        co = node.serving.coalescer
        e = _Entry(None, {}, None)
        e.enqueued = time.perf_counter() - 10.0
        with co._cv:
            co._queues[("idx", "f")] = [e]
        try:
            assert co.oldest_queue_age() >= 10.0
            wd = pkg.watchdog.WatchdogService(node, coalescer_bound_s=1.0,
                                              cooldown_s=0.0)
            trips = _trips(wd, "coalescer_drain")
        finally:
            with co._cv:
                co._queues.clear()
        assert trips and trips[0]["detail"]["oldest_age_seconds"] >= 10.0

    def test_relocation_stall_cancels_and_reschedules(self, pkg, node):
        """A move in flight past the bound trips and is cancelled through
        the allocator with ``reschedule=True``, the wedged target named;
        a cancelled move does not trip twice."""
        calls = []
        mv = {"index": "evt", "shard": 1, "source": "a", "target": "b",
              "age_seconds": 120.0, "cancelled": False}
        alloc = SimpleNamespace(
            inflight_snapshot=lambda: [dict(mv)],
            cancel_relocation=lambda key, reschedule=False, reason="": (
                calls.append((key, reschedule, reason)), mv.update(
                    cancelled=True))[-1])
        saved = getattr(node, "multihost", None)
        node.multihost = SimpleNamespace(allocator=alloc)
        try:
            wd = pkg.watchdog.WatchdogService(node, relocation_bound_s=60.0,
                                              cooldown_s=0.0)
            trips = _trips(wd, "relocation_stall")
            again = _trips(wd, "relocation_stall")
        finally:
            node.multihost = saved
        assert len(trips) == 1 and again == []
        assert trips[0]["detail"]["bound_seconds"] == 60.0
        assert calls == [(("evt", 1, "b"), True, "watchdog trip")]

    def test_the_port_allocator_cancels_and_reschedules(self):
        """The port's allocator acts on the watchdog's cancel: the move's
        gate is pulled and a reschedule bans the wedged target."""
        from elasticsearch_tpu_torch.cluster import allocator as alloc_mod

        started = []
        a = alloc_mod.ClusterAllocator.__new__(alloc_mod.ClusterAllocator)
        a._lock = threading.Lock()
        a._stop = threading.Event()
        a.reschedules = 0
        a.inflight = {}
        task = SimpleNamespace(index="evt", shard=1, source="a", target="b",
                               reason="rebalance", banned=set(),
                               cancel=threading.Event(),
                               snapshot=lambda: {
                                   "index": "evt", "shard": 1, "source": "a",
                                   "target": "b", "age_seconds": 90.0,
                                   "cancelled": task.cancel.is_set()})
        a.inflight[("evt", 1, "b")] = task
        a._reschedule_safe = lambda *args: started.append(args)
        n = Node(name="reloc", device="cpu")
        saved = n.multihost
        n.multihost = SimpleNamespace(allocator=a)
        try:
            trips = _trips(watchdog.WatchdogService(
                n, relocation_bound_s=60.0, cooldown_s=0.0),
                "relocation_stall")
            deadline = time.monotonic() + 5
            while not started and time.monotonic() < deadline:
                time.sleep(0.01)
        finally:
            n.multihost = saved
            n.close()
        assert trips and task.cancel.is_set()
        assert a.reschedules == 1
        assert started and started[0][4] == {"b"}

    def test_metric_delta_snapshots_land_in_ring(self, pkg, node):
        if pkg is REF:
            from elasticsearch_tpu.monitor import kernels
        else:
            from elasticsearch_tpu_torch.monitor import kernels
        wd = pkg.watchdog.WatchdogService(node)
        wd.run_once()  # the first tick sets the baseline
        kernels.record("wd_test_kernel")
        wd.run_once()
        assert any("kernels.wd_test_kernel" in e.get("delta", {})
                   for e in node.flight.ring("metrics"))

    def test_trips_visible_to_bench_counter_delta(self, pkg, node):
        if pkg is REF:
            from elasticsearch_tpu.monitor.metrics import (counters_delta,
                                                           process_counters)
            args = ()
        else:
            from elasticsearch_tpu_torch.monitor.metrics import (
                counters_delta, process_counters)
            args = (node,)
        before = process_counters(*args)
        pkg.faults.inject("watchdog.program_stall", count=1)
        node.watchdog.run_once()
        delta = counters_delta(before, process_counters(*args))
        assert delta.get("watchdog.trips", 0) >= 1
        assert delta.get("watchdog.trips.program_stall", 0) >= 1
        assert delta.get("watchdog.incidents", 0) >= 1

    def test_the_tick_thread_starts_and_stops(self, pkg, node, monkeypatch):
        wd = pkg.watchdog.WatchdogService(node, interval_s=0.01)
        monkeypatch.setenv("ESTPU_WATCHDOG", "0")
        wd.ensure_started()
        assert not wd.running
        monkeypatch.setenv("ESTPU_WATCHDOG", "1")
        wd.ensure_started()
        deadline = time.monotonic() + 5
        while wd.ticks < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert wd.running and wd.ticks >= 2
        wd.close()
        assert not wd.running
        assert not any(t.name == "estpu-watchdog" and t is wd._thread
                       and t.is_alive() for t in threading.enumerate())


# -- incident persistence --------------------------------------------------

class TestIncidentPersistence:
    def test_incident_survives_restart(self, pkg, tmp_path):
        n1 = pkg.node(name="persist-1", data_path=str(tmp_path))
        pkg.faults.inject("watchdog.program_stall", count=1)
        iid = [t["incident_id"] for t in n1.watchdog.run_once()
               if t["incident_id"]][0]
        n1.close()
        pkg.faults.clear()
        n2 = pkg.node(name="persist-2", data_path=str(tmp_path))
        try:
            mine = [e for e in n2.watchdog.incidents.list()
                    if e["id"] == iid]
            assert mine and mine[0].get("persisted")
            payload = n2.watchdog.incidents.load(iid)
            assert payload["detector"] == "program_stall"
            assert "flight" in payload and "hot_threads" in payload
        finally:
            n2.close()

    def test_corrupt_blob_reads_as_clean_miss(self, pkg, tmp_path):
        if pkg is REF:
            from elasticsearch_tpu.index import ivf_cache
        else:
            from elasticsearch_tpu_torch.index import ivf_cache
        n1 = pkg.node(name="corrupt-1", data_path=str(tmp_path))
        try:
            pkg.faults.inject("watchdog.program_stall", count=1)
            iid = [t["incident_id"] for t in n1.watchdog.run_once()
                   if t["incident_id"]][0]
            key = pkg.flight.incident_key(iid)
            ivf_cache.store_blob(key, b"deadbeef\n{not json", "incident")
            n1.watchdog.incidents._payloads.clear()
            assert n1.watchdog.incidents.load(iid) is None
            assert ivf_cache.load_blob(key, "incident") is None  # deleted
        finally:
            n1.close()

    def test_incident_keys_match_the_references(self):
        assert flight.incident_key("ab:1") == ref_flight.incident_key("ab:1")
        assert flight.INCIDENT_VERSION == ref_flight.INCIDENT_VERSION


# -- the REST surface and the bundle's schema ------------------------------

class TestDiagnosticsSchema:
    def test_bundle_schema_and_bounded_rings(self, pkg, node):
        pkg.faults.inject("watchdog.program_stall", count=1)
        node.watchdog.run_once()
        s, out = pkg.controller(node).dispatch("GET", "/_cluster/diagnostics",
                                               {"incidents": "20"}, b"")
        assert s == 200
        assert set(out) == BUNDLE_KEYS and out["version"] == 1
        assert out["_nodes"] == {"total": 1, "successful": 1, "failed": 0}
        entry = out["nodes"][node.node_id]
        assert set(entry) == NODE_KEYS
        fl = entry["flight"]
        assert set(fl["rings"]) == set(pkg.flight.RING_CAPS)
        for name, events in fl["rings"].items():
            assert len(events) <= pkg.flight.RING_CAPS[name], name
            for e in events:
                assert "ts_monotonic" in e and "timestamp_ms" in e
        assert 1 <= len(entry["incident_payloads"]) <= 8

    def test_node_flight_and_cat_incidents(self, pkg, node):
        pkg.faults.inject("watchdog.program_stall", count=1)
        iid = [t["incident_id"] for t in node.watchdog.run_once()
               if t["incident_id"]][0]
        rc = pkg.controller(node)
        s, out = rc.dispatch("GET", "/_nodes/_local/flight", {}, b"")
        assert s == 200 and set(out) == {"flight", "watchdog", "incidents"}
        assert out["flight"]["counts"]["trips"] >= 1
        assert any(e["id"] == iid for e in out["incidents"])
        s, rows = rc.dispatch("GET", "/_cat/incidents", {}, b"")
        assert s == 200
        row = [r for r in rows if r["id"] == iid][0]
        assert row["detector"] == "program_stall"
        assert row["node"] == "wd-node" and row["persisted"] == "false"
        s, payload = rc.dispatch(
            "GET", f"/_cluster/diagnostics/incidents/{iid}", {}, b"")
        assert s == 200 and payload["id"] == iid
        s, body = rc.dispatch(
            "GET", "/_cluster/diagnostics/incidents/nope:1", {}, b"")
        assert s == 404
        assert body["error"]["type"] == "resource_not_found_exception"

    def test_hot_threads_snapshot_is_sleepless_and_capped(self, pkg):
        t0 = time.perf_counter()
        snap = pkg.watchdog.hot_threads_snapshot(limit=4)
        assert time.perf_counter() - t0 < 0.5
        assert len(snap) <= 4
        for row in snap:
            assert row["stack"] and isinstance(row["stack"][0], str)
            assert set(row) == {"name", "ident", "daemon", "sampler",
                                "stack"}

    def test_rest_server_runs_the_watchdog_while_it_serves(self, monkeypatch):
        from elasticsearch_tpu_torch.rest.server import RestServer

        n = Node(name="srv", device="cpu")
        try:
            srv = RestServer(n, host="127.0.0.1", port=0)
            srv.start(background=True)
            assert n.watchdog.running
            srv.stop()
            assert not n.watchdog.running
            monkeypatch.setenv("ESTPU_WATCHDOG", "0")
            srv = RestServer(n, host="127.0.0.1", port=0)
            srv.start(background=True)
            assert not n.watchdog.running
            srv.stop()
        finally:
            n.close()


class TestRunningTime:
    def test_human_time_scales(self):
        from elasticsearch_tpu.tracing.tasks import human_time as ref_ht
        from elasticsearch_tpu_torch.tracing.tasks import human_time

        for nanos in (850_000, 770_000_000, int(12.3e9), int(4.5 * 60e9),
                      int(2.2 * 3600e9)):
            assert human_time(nanos) == ref_ht(nanos)

    def test_tasks_json_and_cat_carry_both_forms(self, pkg, node):
        t = node.tasks.register("indices:data/read/search", "wedged")
        try:
            j = t.to_json()
            assert j["running_time_in_nanos"] >= 0
            assert re.fullmatch(r"[\d.]+(micros|ms|s|m|h)",
                                j["running_time"])
            s, rows = pkg.controller(node).dispatch("GET", "/_cat/tasks",
                                                    {}, b"")
            row = [r for r in rows if r["task_id"] == t.tagged_id][0]
            assert re.fullmatch(r"[\d.]+(micros|ms|s|m|h)",
                                row["running_time"])
        finally:
            node.tasks.unregister(t)


# -- a trio: the publish-window fault, the merged bundle, a dead member ----

@pytest.mark.parametrize("cpkg", CLUSTER_PACKAGES, ids=IDS)
def test_publish_window_fault_trips_and_bundle_merges_members(cpkg):
    """A publish that dies inside the commit window is recorded in the
    master's ``cluster`` ring; its watchdog trips ``publish_stall``; the
    bundle asked of another member carries all three members and the
    master's incident inline; with a member dead the bundle still
    answers 200 and lists it under ``failures``."""
    from elasticsearch_tpu.parallel import aot

    pkg = REF if cpkg.name == "ref" else PORT
    saved = aot._ENABLED
    aot._ENABLED = False
    t = Trio(cpkg)
    try:
        n0 = t.nodes[0]
        cpkg.faults.inject("publish.commit", count=1)
        t[0].data.create_index("diag", {"settings": {"number_of_shards": 2}})
        assert any(e.get("event") == "publish_commit_window_fault"
                   for e in n0.flight.ring("cluster"))
        assert any(e.get("event") == "publish_commit"
                   for e in n0.flight.ring("cluster"))
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            n0.watchdog.run_once()
            if n0.watchdog.stats()["trips"].get("publish_stall", 0) >= 1:
                break
            time.sleep(0.05)
        assert n0.watchdog.stats()["trips"].get("publish_stall", 0) >= 1
        s, out = pkg.controller(t.nodes[1]).dispatch(
            "GET", "/_cluster/diagnostics", {"incidents": "4"}, b"")
        assert s == 200 and set(out) == BUNDLE_KEYS
        assert out["_nodes"] == {"total": 3, "successful": 3, "failed": 0}
        assert set(out["nodes"]) == {n.node_id for n in t.nodes}
        e0 = out["nodes"][n0.node_id]
        assert set(e0) == NODE_KEYS
        assert e0["watchdog"]["trips"].get("publish_stall", 0) >= 1
        inc = [p for p in e0["incident_payloads"]
               if p["detector"] == "publish_stall"][-1]
        assert inc["hot_threads"]
        assert any(e.get("event") == "publish_commit_window_fault"
                   for e in inc["flight"]["rings"]["cluster"])
        s, rows = pkg.controller(t.nodes[2]).dispatch(
            "GET", "/_cat/incidents", {}, b"")
        assert any(r["detector"] == "publish_stall" for r in rows)
        iid = inc["id"]
        s, payload = pkg.controller(t.nodes[2]).dispatch(
            "GET", f"/_cluster/diagnostics/incidents/{iid}", {}, b"")
        assert s == 200 and payload["id"] == iid
        # a member dies abruptly: the bundle still answers
        t[2]._stop.set()
        t[2].transport.close()
        s, out = pkg.controller(n0).dispatch("GET", "/_cluster/diagnostics",
                                             {}, b"")
        assert s == 200
        assert out["_nodes"]["failed"] >= 1 and out["failures"]
        assert n0.node_id in out["nodes"]
    finally:
        t.close()
        aot._ENABLED = saved
