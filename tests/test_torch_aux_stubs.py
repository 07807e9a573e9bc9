"""The port's watcher, river and tribe modules against the reference's.

``watcher.py`` is a working mtime poller, ``river.py`` refuses a river as
the 2.0 line does, and ``tribe.py`` is a documented stub whose one
working part, ``TribeNode.search_remote``, fans a search out over HTTP.
The port's fan-out runs over two launcher processes; the reference's,
its oracle, over two in-process servers with its AOT cache off (its key
holds no device layout, ROADMAP C26).
"""
import os
import re
import signal
import subprocess
import sys
import time

import pytest

from elasticsearch_tpu.river import register_river as ref_register_river
from elasticsearch_tpu.utils.errors import \
    IllegalArgumentException as RefIllegalArgument
from elasticsearch_tpu.watcher import \
    ResourceWatcherService as RefWatcherService
from elasticsearch_tpu_torch.river import register_river
from elasticsearch_tpu_torch.utils.errors import IllegalArgumentException
from elasticsearch_tpu_torch.watcher import ResourceWatcherService

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_resource_watcher_fires_events(tmp_path):
    """Both watchers fire the same events for the same file history."""
    seen = []
    for cls in (RefWatcherService, ResourceWatcherService):
        svc = cls(interval=0.05)
        p = tmp_path / f"synonyms-{cls.__module__}.txt"
        events = []
        svc.add(str(p), lambda path, ev: events.append(ev))
        assert svc.check_now() == 0
        p.write_text("a, b")
        assert svc.check_now() == 1 and events == ["created"]
        p.write_text("a, b, c")
        os.utime(p, (time.time(), time.time() + 1))  # force an mtime change
        assert svc.check_now() == 1
        p.unlink()
        assert svc.check_now() == 1
        svc.remove(str(p))
        assert svc.check_now() == 0
        svc.start()
        svc.stop()
        seen.append(events)
    assert seen[0] == seen[1] == ["created", "changed", "deleted"]


def test_river_registration_rejected_like_2x():
    with pytest.raises(RefIllegalArgument) as r:
        ref_register_river("couchdb", {})
    with pytest.raises(IllegalArgumentException) as p:
        register_river("couchdb", {})
    assert str(p.value) == str(r.value)


def test_tribe_state_federation_is_explicit_stub():
    from elasticsearch_tpu.tribe import TribeNode as RefTribe
    from elasticsearch_tpu_torch.tribe import TribeNode

    for cls in (RefTribe, TribeNode):
        with pytest.raises(NotImplementedError, match="search_remote"):
            cls([]).merged_cluster_state()


def _launch(tmp_path, i):
    proc = subprocess.Popen(
        [sys.executable, "-m", "elasticsearch_tpu_torch.server", "--port",
         "0", "--device", "cpu", "--data-path", str(tmp_path / f"t{i}")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=ROOT))
    line = proc.stdout.readline()
    m = re.search(r"listening on (http://127\.0\.0\.1:\d+)", line)
    assert m, line
    return proc, m.group(1)


def test_tribe_search_fans_out_over_http(tmp_path, monkeypatch):
    """The fan-out over two clusters of 12 docs each: 24 hits in all and
    a 15-hit window, more than 10 from one cluster; the port's over two
    launchers, the reference's over two in-process servers."""
    from elasticsearch_tpu.node import Node as RefNode
    from elasticsearch_tpu.parallel import aot
    from elasticsearch_tpu.rest.server import RestServer as RefServer
    from elasticsearch_tpu.tribe import TribeNode as RefTribe
    from elasticsearch_tpu_torch.client import Client
    from elasticsearch_tpu_torch.tribe import TribeNode

    monkeypatch.setattr(aot, "_ENABLED", False)
    query = {"query": {"match": {"msg": "error"}}}
    procs, urls, ref_nodes, ref_servers, ref_urls = [], [], [], [], []
    try:
        for i in range(2):
            proc, url = _launch(tmp_path, i)
            procs.append(proc)
            urls.append(url)
            c = Client(url=url)
            c.indices.create("logs", {})
            for j in range(12):
                c.index("logs", {"msg": "error in module"}, id=f"c{i}-{j}")
            c.indices.refresh("logs")
            n = RefNode(name=f"trib{i}")
            srv = RefServer(n, host="127.0.0.1", port=0)
            srv.start(background=True)
            ref_nodes.append(n)
            ref_servers.append(srv)
            ref_urls.append(f"http://127.0.0.1:{srv.port}")
            n.create_index("logs", {})
            for j in range(12):
                n.indices["logs"].index_doc(f"c{i}-{j}",
                                            {"msg": "error in module"})
            n.indices["logs"].refresh()
        got = TribeNode(urls).search_remote("logs", query, size=15)
        want = RefTribe(ref_urls).search_remote("logs", query, size=15)
        assert got["hits"]["total"] == want["hits"]["total"] == 24
        assert len(got["hits"]["hits"]) == len(want["hits"]["hits"]) == 15
        assert [(h["_id"], h["_score"]) for h in got["hits"]["hits"]] == \
            [(h["_id"], h["_score"]) for h in want["hits"]["hits"]]
    finally:
        for srv, n in zip(ref_servers, ref_nodes):
            srv.stop()
            n.close()
        for proc in procs:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
                try:
                    proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
