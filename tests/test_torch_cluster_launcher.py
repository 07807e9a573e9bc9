"""Launcher processes as cluster members.

Two ``python -m elasticsearch_tpu_torch.server --device cpu
--coordinator ... --num-processes 2`` processes meet in the gloo
rendezvous (``cluster/bootstrap.py::initialize_distributed``), form one
cluster under process 0's master, serve a distributed index over HTTP
from either member, and exit 0 on SIGTERM.
"""
import os
import re
import signal
import socket
import subprocess
import sys

from _torch_rest import http, ndjson

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    # the rendezvous and the transport take their port from the command
    # line, so the launcher cannot bind 0 and report it: ask the kernel
    # for one and hand it over at once
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait_line(proc, pattern):
    for _ in range(50):
        line = proc.stdout.readline()
        if not line:
            break
        m = re.search(pattern, line)
        if m:
            return m
    raise AssertionError(f"no line matching {pattern!r}")


def test_two_launchers_form_a_cluster_and_exit_on_sigterm(tmp_path):
    rendezvous, transport = _free_port(), _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, ESTPU_HBM_BYTES=str(1 << 30))
    procs = []
    try:
        for rank in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "elasticsearch_tpu_torch.server",
                 "--device", "cpu", "--port", "0", "--name", f"m{rank}",
                 "--coordinator", f"127.0.0.1:{rendezvous}",
                 "--num-processes", "2", "--process-id", str(rank),
                 "--transport-port", str(transport)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                cwd=str(tmp_path), env=env))
        roles, ports = [], []
        for p in procs:
            roles.append(_wait_line(p, r"joined cluster as (\w+)").group(1))
            ports.append(int(_wait_line(
                p, r"listening on http://127\.0\.0\.1:(\d+)").group(1)))
        assert roles == ["master", "data"]
        st, h = http(ports[1], "GET", "/_cluster/health")
        assert st == 200 and h["number_of_nodes"] == 2 and h["term"] == 1
        st, _ = http(ports[1], "PUT", "/evt", {"settings": {
            "number_of_shards": 2, "number_of_replicas": 1}})
        assert st == 200
        lines = []
        for i in range(20):
            lines += [{"index": {"_index": "evt", "_id": f"d{i}"}},
                      {"body": f"alpha w{i % 3}", "n": i}]
        st, out = http(ports[0], "POST", "/_bulk?refresh=true",
                       ndjson=ndjson(lines))
        assert st == 200 and not out["errors"]
        answers = []
        for port in ports:
            st, r = http(port, "POST", "/evt/_search",
                         {"query": {"match": {"body": "w1"}}, "size": 20})
            assert st == 200
            answers.append(([h["_id"] for h in r["hits"]["hits"]],
                            r["hits"]["total"], r["_shards"]))
        assert answers[0] == answers[1]
        assert answers[0][1] == 7
        assert answers[0][2] == {"total": 2, "successful": 2, "failed": 0}
        for p in reversed(procs):
            p.send_signal(signal.SIGTERM)
        for p in procs:
            assert p.wait(timeout=30) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def test_initialize_distributed_is_idempotent():
    """gloo over ``tcp://``; a second call with the group up is a no-op
    (it does not dial the address it is given)."""
    code = (
        "import torch.distributed as d\n"
        "from elasticsearch_tpu_torch.cluster.bootstrap import "
        "initialize_distributed as i\n"
        f"i('127.0.0.1:{_free_port()}', 1, 0)\n"
        "assert d.is_initialized() and d.get_backend() == 'gloo'\n"
        "i('127.0.0.1:1', 1, 0)\n"
        "assert d.get_world_size() == 1\n"
        "d.destroy_process_group()\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
