"""The cluster transport and its wire format, port against reference.

``utils/wire.py`` must give the same JSON for the same objects in both
packages (the members of a mixed cluster could read each other's
frames); the port refuses a tensor instead of copying it off the card in
silence. The transport's framing, backoff, per-peer breaker, typed
remote errors and its two fault points are held against the
reference's on the same inputs.
"""
import json
import socket
import struct
import time

import numpy as np
import pytest
import torch

from elasticsearch_tpu.cluster import transport as ref_t
from elasticsearch_tpu.utils import wire as ref_wire
from elasticsearch_tpu.utils.errors import \
    DocumentMissingException as RefMissing
from elasticsearch_tpu.utils.faults import FAULTS as REF_FAULTS
from elasticsearch_tpu_torch.cluster import transport as port_t
from elasticsearch_tpu_torch.utils import wire as port_wire
from elasticsearch_tpu_torch.utils.errors import \
    DocumentMissingException as PortMissing
from elasticsearch_tpu_torch.utils.faults import FAULTS as PORT_FAULTS

PKGS = [("ref", ref_t, ref_wire, RefMissing, REF_FAULTS),
        ("port", port_t, port_wire, PortMissing, PORT_FAULTS)]


@pytest.fixture(autouse=True)
def _clean():
    REF_FAULTS.clear()
    PORT_FAULTS.clear()
    yield
    REF_FAULTS.clear()
    PORT_FAULTS.clear()


def _objects():
    rng = np.random.default_rng(3)
    return [
        None, True, 7, -2.5, "s", [1, 2, [3]], (1, "a"), {3, 1, 2},
        frozenset({"b", "a"}), b"\x00\xffraw",
        np.int64(5), np.float32(0.25), np.bool_(True),
        np.arange(6, dtype=np.int32).reshape(2, 3),
        np.float64(3.0) * np.ones(()),  # a 0-d array
        rng.random(5).astype(np.float32),
        {"buckets": {1: {"doc_count": 4}, (2, "x"): [np.uint32(9)]},
         "regs": rng.integers(0, 30, 64).astype(np.int32),
         "sample": rng.random(7)},
        [{"_list": [{"a": {0.5: 1}}]}],
    ]


@pytest.mark.parametrize("i", range(len(_objects())))
def test_pack_gives_the_references_json(i):
    obj = _objects()[i]
    a = json.dumps(ref_wire.pack(obj))
    b = json.dumps(port_wire.pack(obj))
    assert a == b
    back = port_wire.unpack(json.loads(b))
    ref_back = ref_wire.unpack(json.loads(a))
    assert repr(back) == repr(ref_back)


def test_a_tensor_is_refused():
    for t in (torch.zeros(3), torch.tensor(1.5),
              {"buckets": [torch.arange(4)]}):
        with pytest.raises(port_wire.TensorOnWireError) as ei:
            port_wire.pack(t)
        assert "tensor" in str(ei.value).lower()
    # it is a TypeError, as the reference's refusal of a foreign type
    assert issubclass(port_wire.TensorOnWireError, TypeError)


def test_ctx_header_is_sanitized_the_same():
    ctx = {"trace": {"trace_id": "t" * 10, "span_id": 5, "x": 1},
           "task": {"node": "n", "id": True}, "junk": {"a": 1}}
    assert port_wire.sanitize_ctx(ctx) == ref_wire.sanitize_ctx(ctx)
    assert port_wire.attach_ctx({}, {"task": {"node": "n", "id": 3}}) == \
        ref_wire.attach_ctx({}, {"task": {"node": "n", "id": 3}})


def test_framing_is_a_length_prefix_and_utf8_json():
    outs = []
    for _name, t, *_ in PKGS:
        a, b = socket.socketpair()
        with a, b:
            n = t._send_frame(a, {"action": "x", "payload": {"k": "é"}})
            raw = b.recv(1 << 16)
            outs.append((n, raw))
            a.sendall(raw)
            assert t._recv_frame(b) == {"action": "x",
                                        "payload": {"k": "é"}}
    assert outs[0] == outs[1]
    n, raw = outs[1]
    assert struct.unpack(">I", raw[:4])[0] == len(raw) - 4 == n - 4
    # an oversized header is refused before any body is read
    a, b = socket.socketpair()
    with a, b:
        a.sendall(struct.pack(">I", (64 << 20) + 1))
        with pytest.raises(port_t.TransportError):
            port_t._recv_frame(b)


def test_backoff_policy_draws_the_same_delays():
    for kw in ({}, {"seed": 11, "base": 0.01, "max_delay": 0.05},
               {"jitter": 0.0}):
        for salt in (None, "peer|action"):
            a = list(ref_t.BackoffPolicy(**kw).delays(6, salt=salt))
            b = list(port_t.BackoffPolicy(**kw).delays(6, salt=salt))
            assert a == b


def test_peer_breaker_opens_half_opens_and_closes():
    def trace(mod):
        now = [0.0]
        br = mod.PeerBreaker(threshold=2, cooldown=5.0,
                             clock=lambda: now[0])
        out = []
        for step in ("f", "f", "a", "t+6", "a", "a", "f", "a", "t+6", "a",
                     "s", "a"):
            if step == "f":
                br.record_failure("p")
            elif step == "s":
                br.record_success("p")
            elif step.startswith("t+"):
                now[0] += float(step[2:])
            else:
                out.append(br.allow("p"))
        return out
    assert trace(port_t) == trace(ref_t) == [
        False, True, False, False, True, True]


def _serve(mod, missing):
    svc = mod.TransportService("n1")
    svc.register("echo", lambda p: {"got": p})
    svc.register("missing", lambda p: (_ for _ in ()).throw(
        missing("idx", p["id"])))
    svc.register("boom", lambda p: (_ for _ in ()).throw(
        RuntimeError("plain failure")))
    host, port = svc.bind(port=0)
    assert port != 0  # bind(port=0) reports the bound port
    return svc, (host, port)


@pytest.mark.parametrize("pkg", PKGS, ids=[p[0] for p in PKGS])
def test_remote_exception_keeps_its_type_and_status(pkg):
    _name, mod, _w, missing, _f = pkg
    svc, addr = _serve(mod, missing)
    client = mod.TransportService("n2")
    try:
        assert client.send_remote(addr, "echo", {"a": [1]}) == \
            {"got": {"a": [1]}}
        with pytest.raises(mod.RemoteException) as ei:
            client.send_remote(addr, "missing", {"id": "d7"})
        assert ei.value.error_type == "document_missing_exception"
        assert ei.value.status == 404
        assert isinstance(ei.value, mod.TransportError)
        with pytest.raises(mod.TransportError) as ei:
            client.send_remote(addr, "boom", {})
        assert not isinstance(ei.value, mod.RemoteException)
        assert "plain failure" in str(ei.value)
        assert client.ping(addr)
    finally:
        svc.close()


@pytest.mark.parametrize("pkg", PKGS, ids=[p[0] for p in PKGS])
def test_transport_fault_points(pkg):
    """``transport.send`` fails before the connect (a typed connect
    error, safe to retry); ``transport.recv`` after the request frame
    went out (the peer ran it; only an idempotent action may retry)."""
    _name, mod, _w, missing, faults = pkg
    svc, addr = _serve(mod, missing)
    client = mod.TransportService("n2")
    calls = []
    svc.register("count", lambda p: calls.append(1) or len(calls))
    try:
        faults.inject("transport.send", error=ConnectionRefusedError,
                      count=1, match=lambda c: c["action"] == "count")
        with pytest.raises(mod.ConnectTransportError):
            client.send_remote(addr, "count", {})
        assert calls == []
        faults.inject("transport.recv", error=OSError, count=1)
        with pytest.raises(mod.TransportError) as ei:
            client.send_remote(addr, "count", {})
        assert not isinstance(ei.value, mod.ConnectTransportError)
        time.sleep(0.05)
        assert calls == [1]  # the peer ran it
        # send_with_retry: two refused connects, then the round lands
        faults.inject("transport.send", error=ConnectionRefusedError,
                      count=2)
        got = client.send_with_retry(
            addr, "count", {}, retries=2,
            backoff=mod.BackoffPolicy(base=0.001, max_delay=0.002))
        assert got == 2
        for _ in range(4):
            client.breaker.record_failure(addr)
        with pytest.raises(mod.NodeUnavailableException):
            client.send_with_retry(addr, "count", {}, retries=0)
    finally:
        svc.close()


def test_transport_spans_join_one_trace():
    """The wire context: a send made inside a span and a task reaches
    the handler as the same trace and as the task's child."""
    from elasticsearch_tpu_torch.tracing import tasks as port_tasks
    from elasticsearch_tpu_torch.tracing.tasks import TaskRegistry
    from elasticsearch_tpu_torch.tracing.tracer import Tracer

    server_tracer = Tracer("srv")
    server_tasks = TaskRegistry("srv")
    svc = port_t.TransportService("srv")
    svc.tracer = server_tracer
    seen = {}

    def handler(p):
        t = server_tasks.register("child")
        seen["parent"] = t.parent
        server_tasks.unregister(t)
        return "ok"

    svc.register("h", handler)
    addr = svc.bind(port=0)
    client_tracer = Tracer("cli")
    client_tasks = TaskRegistry("cli")
    client = port_t.TransportService("cli")
    client.tracer = client_tracer
    try:
        with client_tasks.task("parent") as parent:
            with client_tracer.span("root") as root:
                client.send_remote(addr, "h", {})
        assert seen["parent"] == ("cli", parent.id)
        handle = [s for s in server_tracer.spans()
                  if s.name == "transport.handle"]
        assert handle and handle[0].trace_id == root.trace_id
        assert port_tasks.wire_parent() is None  # restored after
    finally:
        svc.close()


def test_a_connect_that_hangs_is_bounded():
    """A peer whose listen queue is full drops the handshake, as a host
    that drops connects to a closed port does for a dead member: the
    reference waits out the round's whole timeout, the port gives up at
    ``CONNECT_TIMEOUT`` with the typed, retry-safe connect error (ROADMAP
    C27)."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(0)
    addr = srv.getsockname()
    held = []
    for _ in range(4):  # fill the queue: later handshakes are dropped
        c = socket.socket()
        c.setblocking(False)
        try:
            c.connect(addr)
        except BlockingIOError:
            pass
        held.append(c)
    time.sleep(0.2)
    try:
        waited = {}
        for name, mod in (("ref", ref_t), ("port", port_t)):
            t = time.monotonic()
            with pytest.raises(mod.ConnectTransportError) as ei:
                mod.TransportService("n").send_remote(addr, "x", {},
                                                      timeout=3.0)
            waited[name] = time.monotonic() - t
            assert ei.value.timed_out
        assert waited["ref"] >= 2.9
        assert waited["port"] < 2.9
        assert port_t.CONNECT_TIMEOUT == 2.0
    finally:
        for c in held:
            c.close()
        srv.close()
