"""The serving side of the port's REST front door, against the reference's
where both serve the same thing (``tests/_torch_rest.py``).

- A full search queue answers 429 ``es_rejected_execution_exception``
  with a whole HTTP answer (no reset connection).
- Tenant QoS: a tenant over its share of the ``in_flight_requests``
  breaker gets 429 while another tenant answers 200; the port's breakers
  belong to its node, the reference's to its process (a known
  difference, held here).
- The in-flight breaker on a non-search route.
- ``_tasks``: list, get and cancel of a by-query, of a scroll and of a
  request parked in the coalescer.
- ``/_prometheus/metrics``: ``estpu_rest_requests_total`` counts the
  requests sent; the family names and label names equal the
  reference's but for the families whose layers come later.
- The launcher as a subprocess with ``--device cpu``: bulk, search,
  SIGTERM, exit 0; its multi-host flags refused.
- ``Client`` against the reference's ``Client``, over HTTP and in
  process.
"""
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time

import pytest

from _torch_parity import corpus
from _torch_rest import Pair, http, ndjson, node_ids_out, same

MAPPING = {"properties": {"body": {"type": "text"},
                          "tag": {"type": "keyword"},
                          "n": {"type": "long"}}}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: families of the reference's exposition the port lacks: none (the
#: compile/warm layer's eight, ``estpu_program_*``, ``estpu_jit_traces_total``,
#: ``estpu_compile_cache_*`` and ``estpu_warmup_*``, are served)
REFERENCE_ONLY_FAMILIES: set = set()


#: families of the process-shared registries, present once the process
#: recorded them
PROCESS_SHARED_FAMILIES = {"estpu_translog_fsync_duration_seconds",
                           "estpu_translog_fsyncs_total",
                           "estpu_hybrid_rerank_total"}


def _process_shared_families() -> set:
    """Every family the two process-shared registries hold now: the
    packages' own (``PROCESS_SHARED_FAMILIES``) and any a test of the
    same process made there (``tests/unit/test_metrics.py`` makes
    ``estpu_test_shared_total`` in the reference's), so they depend on
    which tests ran before in the worker (ROADMAP C28)."""
    from elasticsearch_tpu.monitor.metrics import SHARED as REF_SHARED
    from elasticsearch_tpu_torch.monitor.metrics import SHARED

    return set(_families(REF_SHARED.expose())) | \
        set(_families(SHARED.expose()))


@pytest.fixture(scope="module")
def pair():
    p = Pair()
    yield p
    p.close()


@pytest.fixture
def idx(pair):
    pair.wipe()
    pair.same("PUT", "/logs", {"settings": {"index": {
        "number_of_shards": 2, "search": {"mesh": "false"}}},
        "mappings": MAPPING})
    lines = []
    for doc_id, src in corpus(200, seed=9):
        lines += [{"index": {"_index": "logs", "_id": doc_id}},
                  {"body": src["body"], "tag": src["tag"],
                   "n": int(doc_id[1:])}]
    pair.same("POST", "/_bulk?refresh=true", ndjson=ndjson(lines))
    yield pair
    for node in (pair.ref, pair.port):
        node.serving.apply_cluster_settings({})


def _servers(pair):
    return ((pair.ref, pair.ref_server.port),
            (pair.port, pair.port_server.port))


def test_full_search_queue_answers_429(idx):
    from elasticsearch_tpu.utils.threadpool import \
        FixedThreadPool as RefPool
    from elasticsearch_tpu_torch.utils.threadpool import FixedThreadPool

    for (node, port), cls in zip(_servers(idx), (RefPool, FixedThreadPool)):
        pools = node.thread_pool.pools
        old = pools["search"]
        pools["search"] = cls("search", 1, 1)
        gate = threading.Event()
        holders = [threading.Thread(
            target=pools["search"].execute, args=(gate.wait, 30))
            for _ in range(2)]
        try:
            for t in holders:  # the worker, then the one queue slot
                t.start()
                time.sleep(0.05)
            status, out = http(port, "POST", "/logs/_search",
                               {"query": {"match_all": {}}})
            assert status == 429
            assert out["error"]["type"] == "es_rejected_execution_exception"
            assert pools["search"].stats()["rejected"] == 1
            # other pools still serve
            assert http(port, "GET", "/logs/_doc/d1")[0] == 200
        finally:
            gate.set()
            for t in holders:
                t.join(30)
            assert not any(t.is_alive() for t in holders)
            pools["search"].shutdown()
            pools["search"] = old
        assert http(port, "POST", "/logs/_count")[0] == 200


def test_tenant_over_its_share_gets_429(idx):
    settings = {"transient": {
        "network.breaker.inflight_requests.limit": "64kb",
        "serving.qos.tenant.greedy.weight": 1,
        "serving.qos.tenant.calm.weight": 1}}
    idx.same("PUT", "/_cluster/settings", settings)
    body = {"query": {"match": {"body": "fox"}}}
    for node, port in _servers(idx):
        qos = node.serving.qos
        # greedy already holds its whole share in flight
        held = qos.admit("greedy", 32 * 1024)
        try:
            st, out = http(port, "POST", "/logs/_search", body,
                           headers={"X-Tenant-Id": "greedy"})
            assert st == 429
            assert out["error"]["type"] == "circuit_breaking_exception"
            assert "tenant share" in out["error"]["reason"]
            st, _ = http(port, "POST", "/logs/_search?tenant=calm", body)
            assert st == 200
        finally:
            qos.release(held)
        st, _ = http(port, "POST", "/logs/_search", body,
                     headers={"X-Tenant-Id": "greedy"})
        assert st == 200
    (_, r), (_, p) = idx.both("GET", "/_nodes/stats")
    r, p = (next(iter(x["nodes"].values()))["serving"]["qos"]
            for x in (r, p))
    same(r, p)
    idx.same("PUT", "/_cluster/settings", {"transient": {
        k: None for k in settings["transient"]}})


def test_breakers_belong_to_the_node_in_the_port():
    """The reference's breakers are process-wide (``resources.BREAKERS``);
    the port's belong to each node: a second port node's in-flight
    budget is its own."""
    from elasticsearch_tpu import resources as ref_resources
    from elasticsearch_tpu.node import Node as RefNode
    from elasticsearch_tpu_torch.node import Node

    a, b = Node(name="a", device="cpu"), Node(name="b", device="cpu")
    ra, rb = RefNode(name="ra"), RefNode(name="rb")
    try:
        tok = a.serving.qos.admit("t", 10_000)
        assert a.breakers.breaker("in_flight_requests").used == 10_000
        assert b.breakers.breaker("in_flight_requests").used == 0
        a.serving.qos.release(tok)
        inflight = ref_resources.BREAKERS.breaker("in_flight_requests")
        before = inflight.used
        tok = ra.serving.qos.admit("t", 10_000)
        assert inflight.used == before + 10_000  # shared by ra and rb
        ra.serving.qos.release(tok)
    finally:
        for n in (a, b, ra, rb):
            n.close()


def test_in_flight_breaker_on_a_write(idx):
    idx.same("PUT", "/_cluster/settings", {"transient": {
        "network.breaker.inflight_requests.limit": "100b"}})
    big = {"body": "x" * 400}
    idx.same("PUT", "/logs/_doc/big", big)
    idx.same("PUT", "/logs/_doc/small", {"b": 1})
    idx.same("PUT", "/_cluster/settings", {"transient": {
        "network.breaker.inflight_requests.limit": None}})
    idx.same("PUT", "/logs/_doc/big", big)


def _wait_task(port, actions, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st, out = http(port, "GET", f"/_tasks?actions={actions}")
        assert st == 200
        tasks = [t for n in out["nodes"].values()
                 for t in n["tasks"].values()]
        if tasks:
            return tasks[0]
        time.sleep(0.01)
    raise AssertionError(f"no task matching {actions}")


def _slow_deletes(node, monkeypatch):
    svc = node.indices["logs"]
    real = svc.delete_doc

    def slow(*a, **kw):
        time.sleep(0.02)
        return real(*a, **kw)

    monkeypatch.setattr(svc, "delete_doc", slow)


def test_cancel_a_by_query(idx, monkeypatch):
    answers = {}
    for node, port in _servers(idx):
        _slow_deletes(node, monkeypatch)
        out = {}
        th = threading.Thread(target=lambda: out.update(r=http(
            port, "POST", "/logs/_delete_by_query",
            {"query": {"match_all": {}}})))
        th.start()
        task = _wait_task(port, "*byquery")
        assert task["action"] == "indices:data/write/delete/byquery"
        tid = f"{task['node']}:{task['id']}"
        st, got = http(port, "GET", f"/_tasks/{tid}")
        assert st == 200 and got["task"]["id"] == task["id"]
        st, cancelled = http(port, "POST", f"/_tasks/{tid}/_cancel")
        assert st == 200 and list(cancelled["nodes"]) == [node.node_id]
        th.join(30)
        assert not th.is_alive()
        st, res = out["r"]
        assert st == 200 and "canceled" in res
        assert res["deleted"] < 200
        answers[port] = (cancelled, res)
        assert http(port, "GET", f"/_tasks/{tid}")[0] == 404
    (rc, rr), (pc, pr) = answers.values()
    assert set(rr) == set(pr)
    same(node_ids_out(rc, idx.ref.node_id),
         node_ids_out(pc, idx.port.node_id), ignore=("description",))
    idx.same("GET", "/_tasks/nonode:99")
    idx.same("GET", "/_tasks/bad")
    idx.same("POST", "/_tasks/nonode:99/_cancel")


def _by_queries(node, n_tasks, timeout=20.0):
    """The node's running by-query tasks, read in process (on the
    reference, ``GET /_tasks`` would queue behind them), once there are
    ``n_tasks``."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        tasks = node.tasks.list_tasks("*byquery")
        if len(tasks) == n_tasks:
            return tasks
        time.sleep(0.01)
    raise AssertionError(f"{n_tasks} by-queries never ran together")


def _two_by_queries(port):
    """Start two by-queries over the two halves of the index; returns
    their threads and the dict their answers land in."""
    out = {}
    threads = []
    for key, rng in (("low", {"lt": 100}), ("high", {"gte": 100})):
        th = threading.Thread(target=lambda key=key, rng=rng: out.update(
            {key: http(port, "POST", "/logs/_delete_by_query",
                       {"query": {"range": {"n": rng}}})}))
        th.start()
        threads.append(th)
    return threads, out


def test_cancel_answers_while_two_by_queries_run(idx, monkeypatch):
    """ROADMAP C22. The reference runs by-queries and ``_tasks`` on its
    2-worker ``management`` pool: with two by-queries running, a cancel
    waits behind the very runs it should stop (pinned below). The port
    runs by-queries on ``bulk``, so the cancel answers while both run
    and stops the one it names."""
    (ref, ref_port), (node, port) = _servers(idx)
    for n in (ref, node):
        _slow_deletes(n, monkeypatch)

    # the reference: the cancel gets no answer while both run
    threads, out = _two_by_queries(ref_port)
    first = _by_queries(ref, 2)[0]
    got = {}
    cancel = threading.Thread(target=lambda: got.update(
        r=http(ref_port, "POST", f"/_tasks/{first.tagged_id}/_cancel"),
        left=len(ref.tasks.list_tasks("*byquery"))))
    cancel.start()
    cancel.join(0.5)
    assert cancel.is_alive()
    assert len(ref.tasks.list_tasks("*byquery")) == 2
    for th in threads + [cancel]:
        th.join(60)
        assert not th.is_alive()
    # it ran only once a by-query had ended and freed its worker, and the
    # by-query it did not name ran to its end
    assert got["left"] <= 1
    assert all(st == 200 for st, _res in out.values())
    assert any("canceled" not in res and res["deleted"] == 100
               for _st, res in out.values())

    # the port: the cancel answers while both run
    lines = []
    for doc_id, src in corpus(200, seed=9):
        lines += [{"index": {"_index": "logs", "_id": doc_id}},
                  {"body": src["body"], "tag": src["tag"],
                   "n": int(doc_id[1:])}]
    st, _ = http(port, "POST", "/_bulk?refresh=true", ndjson=ndjson(lines))
    assert st == 200
    threads, out = _two_by_queries(port)
    first, second = _by_queries(node, 2)
    st, cancelled = http(port, "POST", f"/_tasks/{first.tagged_id}/_cancel")
    assert st == 200 and list(cancelled["nodes"]) == [node.node_id]
    running = node.tasks.list_tasks("*byquery")
    assert second in running, "the other by-query ended before the cancel"
    st, _ = http(port, "POST", f"/_tasks/{second.tagged_id}/_cancel")
    assert st == 200
    for th in threads:
        th.join(60)
        assert not th.is_alive()
    for key in ("low", "high"):
        st, res = out[key]
        assert st == 200 and "canceled" in res
        assert res["deleted"] < 100


def test_cancel_a_scroll(idx):
    for node, port in _servers(idx):
        st, first = http(port, "POST", "/logs/_search?scroll=1m",
                         {"query": {"match_all": {}}, "size": 5})
        sid = first["_scroll_id"]
        st, _ = http(port, "POST", "/_search/scroll", {"scroll_id": sid})
        assert st == 200
        task = _wait_task(port, "indices:data/read/scroll")
        st, _ = http(port, "POST",
                     f"/_tasks/{task['node']}:{task['id']}/_cancel")
        assert st == 200
        st, out = http(port, "POST", "/_search/scroll", {"scroll_id": sid})
        assert st == 404
        assert out["error"]["type"] == "search_context_missing_exception"
        st, out = http(port, "GET", "/_tasks?actions=*scroll")
        assert not any(n["tasks"] for n in out["nodes"].values())


def test_cancel_a_parked_coalescer_request(idx):
    idx.same("PUT", "/_cluster/settings", {"transient": {
        "serving.coalescer.mode": "always",
        "serving.coalescer.max_wait": "20s",
        "serving.coalescer.idle_gap": "20s"}})
    try:
        for node, port in _servers(idx):
            out = {}
            th = threading.Thread(target=lambda: out.update(r=http(
                port, "POST", "/logs/_search",
                {"query": {"match": {"body": "fox"}}})))
            th.start()
            task = _wait_task(port, "*coalesced*")
            assert task["status"] == "pending"
            st, pend = http(port, "GET", "/_cluster/pending_tasks")
            assert [t["source"] for t in pend["tasks"]] == \
                ["indices:data/read/search[coalesced]"]
            st, _ = http(port, "POST",
                         f"/_tasks/{task['node']}:{task['id']}/_cancel")
            assert st == 200
            th.join(30)
            assert not th.is_alive()
            st, res = out["r"]
            assert st == 400
            assert res["error"]["type"] == "task_cancelled_exception"
            assert "while queued" in res["error"]["reason"]
    finally:
        idx.same("PUT", "/_cluster/settings", {"transient": {
            "serving.coalescer.mode": None,
            "serving.coalescer.max_wait": None,
            "serving.coalescer.idle_gap": None}})


def _families(text: str) -> dict:
    """{family: set of label-name sets} of an exposition."""
    out: dict = {}
    for line in text.splitlines():
        if line.startswith("# TYPE"):
            out.setdefault(line.split()[2], set())
        elif line and not line.startswith("#"):
            m = re.match(r"([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?", line)
            name = m.group(1)
            if name not in out:
                name = re.sub(r"_(bucket|sum|count)$", "", name)
            labels = frozenset(re.findall(r'(\w+)="', m.group(2) or ""))
            out.setdefault(name, set()).add(labels - {"le"})
    return out


def _rest_requests(text: str) -> int:
    return sum(int(float(line.rsplit(" ", 1)[1]))
               for line in text.splitlines()
               if line.startswith("estpu_rest_requests_total{"))


def test_prometheus_metrics(idx):
    (rs, r0), (ps, p0) = idx.both("GET", "/_prometheus/metrics")
    assert rs == ps == 200
    sent = [("GET", "/"), ("POST", "/logs/_search"),
            ("GET", "/logs/_doc/d3"), ("GET", "/logs/_doc/nope"),
            ("POST", "/logs/_count"), ("GET", "/_cluster/health"),
            ("GET", "/_nope/_nope/_nope")]
    for method, path in sent:
        idx.both(method, path)
    (_, r1), (_, p1) = idx.both("GET", "/_prometheus/metrics")
    # the first scrape counts itself once it has rendered; the unknown
    # route answers before any route's metrics
    for before, after in ((r0, r1), (p0, p1)):
        assert _rest_requests(after) - _rest_requests(before) == \
            len(sent) - 1 + 1
    assert 'estpu_rest_requests_total{endpoint="/{index}/_doc/{id}",' \
        'method="GET",status="4xx"} 1' in p1
    # the process-shared families appear once anything in the process
    # recorded them (a translog's sync, a hybrid re-rank, another test):
    # the packages' own are compared by test_translog_fsync_families
    # below, not here; each node's own registry is compared exactly
    shared = PROCESS_SHARED_FAMILIES | _process_shared_families()
    fr, fp = ({k: v for k, v in _families(x).items() if k not in shared}
              for x in (r1, p1))
    assert "estpu_watchdog_trips_total" in fp
    assert set(fr) - set(fp) == REFERENCE_ONLY_FAMILIES, \
        set(fr) ^ set(fp) ^ REFERENCE_ONLY_FAMILIES
    assert set(fp) - set(fr) == set()
    for name in fp:
        assert fp[name] == fr[name], name


def test_translog_fsync_families(tmp_path):
    from elasticsearch_tpu.index.translog import Translog as RefTranslog
    from elasticsearch_tpu.monitor.metrics import SHARED as REF_SHARED
    from elasticsearch_tpu_torch.index.translog import Translog
    from elasticsearch_tpu_torch.monitor.metrics import SHARED

    for cls, shared, name in ((RefTranslog, REF_SHARED, "r"),
                              (Translog, SHARED, "p")):
        tl = cls(str(tmp_path / name))
        before = shared.counter_values().get("estpu_translog_fsyncs_total",
                                             0.0)
        tl.sync()
        tl.close()
        assert shared.counter_values()["estpu_translog_fsyncs_total"] == \
            before + 1
    fams = [{k: v for k, v in _families(s.expose()).items()
             if k.startswith("estpu_translog_")}
            for s in (REF_SHARED, SHARED)]
    assert fams[0] == fams[1] and len(fams[0]) == 2


def test_keep_alive_requests_are_not_held_by_nagle(pair):
    """ROADMAP C21: the handler writes the headers and the body in two
    sends. With Nagle's algorithm on (the reference) the body waits for
    the ACK of the headers, which a keep-alive client delays (~40 ms on
    Linux); the port's handler sets TCP_NODELAY."""
    import http.client
    import statistics

    medians = []
    for port in (pair.ref_server.port, pair.port_server.port):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        ms = []
        for _ in range(8):
            t = time.perf_counter()
            conn.request("GET", "/")
            resp = conn.getresponse()
            assert resp.status == 200 and json.loads(resp.read())["name"]
            ms.append((time.perf_counter() - t) * 1e3)
        conn.close()
        medians.append(statistics.median(ms))
    assert medians[0] >= 30 and medians[1] < 20, medians


def test_launcher_subprocess(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "elasticsearch_tpu_torch.server", "--port",
         "0", "--device", "cpu", "--data-path", str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(tmp_path), env=env)
    try:
        line = proc.stdout.readline()
        m = re.search(r"listening on http://127\.0\.0\.1:(\d+)", line)
        assert m, line
        port = int(m.group(1))
        st, info = http(port, "GET", "/")
        assert st == 200 and info["devices"] == ["cpu"]
        lines = []
        for doc_id, src in corpus(50, seed=1):
            lines += [{"index": {"_index": "l", "_id": doc_id}}, src]
        st, out = http(port, "POST", "/_bulk?refresh=true",
                       ndjson=ndjson(lines))
        assert st == 200 and not out["errors"]
        st, out = http(port, "POST", "/l/_search",
                       {"query": {"match": {"body": "fox"}}})
        assert st == 200 and out["hits"]["total"] > 0
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=10) == 0
        assert os.path.exists(tmp_path / "l" / "_meta.json")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_launcher_refuses_multi_host_flags():
    """The launcher takes the reference's five multi-host flags (a
    two-member cluster of launchers runs in
    ``tests/test_torch_cluster_launcher.py``) and, as the reference's
    argparse does, refuses a malformed value with exit 2 naming it."""
    out = subprocess.run(
        [sys.executable, "-m", "elasticsearch_tpu_torch.server", "--help"],
        capture_output=True, text=True, cwd=ROOT, timeout=60)
    assert out.returncode == 0
    for flag in ("--coordinator", "--num-processes", "--process-id",
                 "--transport-port", "--minimum-master-nodes"):
        assert flag in out.stdout
    out = subprocess.run(
        [sys.executable, "-m", "elasticsearch_tpu_torch.server",
         "--coordinator", "127.0.0.1:1234", "--num-processes", "two"],
        capture_output=True, text=True, cwd=ROOT, timeout=60)
    assert out.returncode == 2
    assert "--num-processes" in out.stderr


def test_client_against_the_reference_client(idx):
    from elasticsearch_tpu.client import Client as RefClient
    from elasticsearch_tpu_torch import Client

    pairs = ((RefClient(url=f"http://127.0.0.1:{idx.ref_server.port}"),
              Client(url=f"http://127.0.0.1:{idx.port_server.port}")),
             (RefClient(node=idx.ref), Client(node=idx.port)))
    for rc, pc in pairs:
        for call in (
                lambda c: c.index("logs", {"body": "client doc"}, id="c1",
                                  refresh=True),
                lambda c: c.get("logs", "c1"),
                lambda c: c.exists("logs", "c1"),
                lambda c: c.update("logs", "c1", {"doc": {"tag": "u"}}),
                lambda c: c.mget("logs", ["c1", "d2"]),
                lambda c: c.search("logs", {"query": {"term": {
                    "tag": "t1"}}, "size": 5}),
                lambda c: c.count("logs", {"query": {"term": {
                    "tag": "t1"}}}),
                lambda c: c.msearch([({"index": "logs"}, {"size": 2})]),
                lambda c: c.bulk([{"index": {"_index": "logs",
                                             "_id": "c2"}},
                                  {"body": "bulk"}], refresh=True),
                lambda c: c.delete("logs", "c2", refresh=True),
                lambda c: c.indices.exists("logs"),
                lambda c: c.indices.refresh("logs"),
                lambda c: c.indices.get_mapping("logs"),
                lambda c: c.indices.analyze(body={"text": "Foxes Ran",
                                                  "analyzer": "english"}),
                lambda c: c.cluster.health()):
            same(node_ids_out(call(rc), idx.ref.node_id),
                 node_ids_out(call(pc), idx.port.node_id))
        same(rc.info(), pc.info(), ignore=("devices", "build_flavor",
                                           "tagline"))
