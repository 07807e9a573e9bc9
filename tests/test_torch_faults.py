"""The port's fault registry (``utils/faults.py``) against the
reference's, on the scenarios of the reference's chaos suite.

- Registry semantics: ``count``, ``after``, ``match`` and the seeded
  ``prob`` stream fire on the same ``check`` calls in both packages, and
  ``fired``/``history``/``active`` agree.
- The ``ESTPU_FAULTS`` spec: the same grammar arms the same faults in
  both, and the same malformed specs raise the same errors.
- The translog points: an fsync or append fault closes the translog and
  fails the engine closed (a typed 503 through REST), and a replay holds
  exactly the acknowledged ops; ``segment.freeze`` fails a refresh
  retryably.
- A transport flake within the retry budget, counted by ``fired``.
- A launcher subprocess armed through ``ESTPU_FAULTS``.
"""
import os
import re
import signal
import subprocess
import sys

import pytest

from _torch_rest import http
from elasticsearch_tpu.utils import faults as ref_faults
from elasticsearch_tpu_torch.utils import faults

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = (ref_faults, faults)


@pytest.fixture(autouse=True)
def _clean_slate():
    for mod in PACKAGES:
        mod.FAULTS.clear()
    yield
    for mod in PACKAGES:
        mod.FAULTS.clear()


def _pattern(mod, calls, **inject):
    """The firing sequence (1 fired, 0 let through) of ``calls`` checks
    of one point, each with its ctx."""
    r = mod.FaultRegistry()
    r.inject("transport.send", error=OSError, **inject)
    out = []
    for ctx in calls:
        try:
            r.check("transport.send", **ctx)
            out.append(0)
        except OSError:
            out.append(1)
    return out, r


def test_point_sets_are_equal():
    assert faults.POINTS == ref_faults.POINTS
    assert "watchdog.program_stall" in faults.POINTS


@pytest.mark.parametrize("inject", [
    {"count": 2, "after": 1},
    {"count": -1, "after": 3},
    {"count": 3, "prob": 0.5, "seed": 7},
    {"count": -1, "prob": 0.5, "seed": 7},
    {"count": -1, "prob": 0.3, "seed": 8, "after": 5},
    {"count": 4, "after": 2, "prob": 0.7, "seed": 11,
     "match": lambda ctx: ctx.get("action") == "q"},
], ids=["count-after", "after-unlimited", "prob-count", "prob-unlimited",
        "prob-after", "prob-after-match"])
def test_same_injection_fires_on_the_same_checks(inject):
    calls = [{"action": "q" if i % 3 else "f"} for i in range(64)]
    (ra, rr), (pa, pr) = (_pattern(mod, calls, **inject)
                          for mod in PACKAGES)
    assert pa == ra
    assert 0 < sum(pa) < len(calls)
    assert pr.fired("transport.send") == rr.fired("transport.send") \
        == sum(pa)
    assert [c for _p, c in pr.history] == [c for _p, c in rr.history]
    assert pr.active("transport.send") == rr.active("transport.send")


def test_count_and_after_gates():
    for mod in PACKAGES:
        r = mod.FaultRegistry()
        r.inject("translog.fsync", error=OSError, count=2, after=1)
        r.check("translog.fsync")  # after=1 lets the first through
        for _ in range(2):
            with pytest.raises(OSError):
                r.check("translog.fsync")
        r.check("translog.fsync")  # count spent: disarmed
        assert not r.active("translog.fsync")
        assert len(r.history) == 2


def test_a_different_seed_is_a_different_storm():
    calls = [{}] * 64
    for mod in PACKAGES:
        a = _pattern(mod, calls, count=-1, prob=0.5, seed=7)[0]
        assert a == _pattern(mod, calls, count=-1, prob=0.5, seed=7)[0]
        assert a != _pattern(mod, calls, count=-1, prob=0.5, seed=8)[0]


def test_env_spec_arms_the_same_faults():
    spec = ("translog.fsync:count=2;"
            "transport.send:prob=0.5:seed=3:error=connrefused;"
            " watchdog.program_stall:after=1 ;segment.freeze:error=breaker")
    regs = []
    for mod in PACKAGES:
        r = mod.FaultRegistry()
        mod._parse_env_spec(spec, r)
        regs.append(r)
        for point in ("translog.fsync", "transport.send",
                      "watchdog.program_stall", "segment.freeze"):
            assert r.active(point), point
    # the same firing on the same checks, with the same error kinds
    kinds = []
    for r in regs:
        seq = []
        for point in ["transport.send"] * 16 + ["watchdog.program_stall"] * 3 \
                + ["segment.freeze", "translog.fsync", "translog.fsync",
                   "translog.fsync"]:
            try:
                r.check(point)
                seq.append(None)
            except Exception as e:  # the armed error kinds are the point
                seq.append(type(e).__name__)
        kinds.append(seq)
    assert kinds[0] == kinds[1]
    assert "ConnectionRefusedError" in kinds[1]
    assert "CircuitBreakingException" in kinds[1]


@pytest.mark.parametrize("spec,err", [
    ("translog.fsync:bogus=1", ValueError),
    ("no.such.point:count=1", ValueError),
    ("translog.fsync:error=nope", KeyError),
    ("translog.fsync:count=two", ValueError),
])
def test_env_spec_errors_match(spec, err):
    msgs = []
    for mod in PACKAGES:
        with pytest.raises(err) as ei:
            mod._parse_env_spec(spec, mod.FaultRegistry())
        msgs.append(str(ei.value).split(" — ")[0])
    assert msgs[0] == msgs[1]


def _node(mod_name, tmp_path, name):
    if mod_name == "ref":
        from elasticsearch_tpu.node import Node as RefNode

        return RefNode(name=name, data_path=str(tmp_path / name))
    from elasticsearch_tpu_torch.node import Node

    return Node(name=name, data_path=str(tmp_path / name), device="cpu")


def _translogs(mod_name):
    if mod_name == "ref":
        from elasticsearch_tpu.index.translog import (Translog,
                                                      TranslogClosedException)
    else:
        from elasticsearch_tpu_torch.index.translog import (
            Translog, TranslogClosedException)
    return Translog, TranslogClosedException


@pytest.mark.parametrize("point", ["translog.fsync", "translog.append"])
def test_translog_fault_fails_the_engine_closed(tmp_path, point):
    """The fault's op is refused, every later write is refused with a
    typed 503, and a replay holds exactly the acknowledged op: in both
    packages alike."""
    out = {}
    for mod_name, mod in zip(("ref", "port"), PACKAGES):
        node = _node(mod_name, tmp_path, mod_name)
        try:
            node.create_index("wal", {"settings": {"number_of_shards": 1}})
            svc = node.indices["wal"]
            svc.index_doc("1", {"v": 1})
            mod.FAULTS.inject(point, error=OSError, count=1)
            errs = []
            for i in (2, 3):
                with pytest.raises(Exception) as ei:
                    svc.index_doc(str(i), {"v": i})
                errs.append((ei.value.status, ei.value.error_type))
            engine = svc.groups[0].primary.engine
            assert engine.is_failed
            Translog, _closed = _translogs(mod_name)
            replayed = [op["id"] for op in
                        Translog(engine.translog.path).replay()
                        if op["op"] == "index"]
            out[mod_name] = (errs, replayed, mod.FAULTS.fired(point))
        finally:
            node.close()
    assert out["port"] == out["ref"] == (
        [(503, "engine_failed_exception")] * 2, ["1"], 1)


def test_fsync_fault_surfaces_as_typed_503_through_rest(tmp_path):
    from elasticsearch_tpu.rest.server import RestController as RefCtrl
    from elasticsearch_tpu_torch.rest.server import RestController

    out = {}
    for mod_name, mod, ctrl_cls in zip(("ref", "port"), PACKAGES,
                                       (RefCtrl, RestController)):
        node = _node(mod_name, tmp_path, mod_name)
        ctrl = ctrl_cls(node)
        try:
            seq = [ctrl.dispatch("PUT", "/logs/_doc/1", {}, b'{"v": 1}')[0]]
            mod.FAULTS.inject("translog.fsync", error=OSError, count=1)
            for v in (2, 3):
                st, body = ctrl.dispatch("PUT", "/logs/_doc/1", {},
                                         b'{"v": %d}' % v)
                seq.append((st, body["error"]["type"]))
            out[mod_name] = seq
        finally:
            node.close()
    assert out["port"] == out["ref"] == [
        201, (503, "engine_failed_exception"),
        (503, "engine_failed_exception")]


def test_translog_append_after_tragic_close_is_refused(tmp_path):
    for mod_name, mod in zip(("ref", "port"), PACKAGES):
        Translog, Closed = _translogs(mod_name)
        tl = Translog(str(tmp_path / mod_name))
        tl.append({"op": "index", "id": "1", "source": {}})
        mod.FAULTS.inject("translog.fsync", error=OSError, count=1)
        with pytest.raises(OSError):
            tl.append({"op": "index", "id": "2", "source": {}})
        with pytest.raises(Closed):
            tl.append({"op": "index", "id": "3", "source": {}})
        assert tl.stats()["closed"]
        assert [op["id"] for op in Translog(str(tmp_path / mod_name))
                .replay()] == ["1"]


def test_segment_freeze_fault_is_retryable_not_tragic(tmp_path):
    for mod_name, mod in zip(("ref", "port"), PACKAGES):
        node = _node(mod_name, tmp_path, mod_name)
        try:
            node.create_index("frz", {"settings": {"number_of_shards": 1}})
            svc = node.indices["frz"]
            svc.index_doc("1", {"v": 1})
            mod.FAULTS.inject("segment.freeze", error=OSError, count=1)
            with pytest.raises(OSError):
                svc.refresh()
            assert mod.FAULTS.fired("segment.freeze") == 1
            svc.refresh()  # the buffer kept the doc
            assert svc.search({"size": 0})["hits"]["total"] == 1
            assert not svc.groups[0].primary.engine.is_failed
        finally:
            node.close()


def test_transport_flake_is_retried_within_the_budget():
    from elasticsearch_tpu.cluster.transport import \
        TransportService as RefTransport
    from elasticsearch_tpu_torch.cluster.transport import TransportService

    for mod, cls in zip(PACKAGES, (RefTransport, TransportService)):
        ts = cls("n1")
        ts.register("echo", lambda p: p)
        addr = ts.bind()
        try:
            mod.FAULTS.inject("transport.send",
                              error=ConnectionRefusedError, count=1)
            assert ts.send_with_retry(addr, "echo", {"v": 1}, timeout=2.0,
                                      retries=2) == {"v": 1}
            assert mod.FAULTS.fired("transport.send") == 1
        finally:
            ts.close()


def test_env_spec_arms_a_launcher(tmp_path):
    """``ESTPU_FAULTS`` arms a launcher process at import: the second
    write's fsync fails, the engine fails closed (503), and a restart
    without the spec serves exactly the acknowledged write."""
    def launch(env_extra):
        proc = subprocess.Popen(
            [sys.executable, "-m", "elasticsearch_tpu_torch.server",
             "--port", "0", "--device", "cpu", "--data-path",
             str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=str(tmp_path),
            env=dict(os.environ, PYTHONPATH=ROOT, **env_extra))
        m = re.search(r"listening on http://127\.0\.0\.1:(\d+)",
                      proc.stdout.readline())
        assert m
        return proc, int(m.group(1))

    def stop(proc):
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0

    env = {k: v for k, v in os.environ.items() if k != "ESTPU_FAULTS"}
    os.environ.pop("ESTPU_FAULTS", None)
    # the index's creation and the first write fsync once each (in both
    # packages); the third fsync, the second write's, fails
    proc, port = launch({"ESTPU_FAULTS": "translog.fsync:after=2:count=1"})
    try:
        st, _ = http(port, "PUT", "/logs", {"settings": {
            "number_of_shards": 1}})
        assert st == 200
        st, _ = http(port, "PUT", "/logs/_doc/1", {"v": 1})
        assert st == 201
        st, body = http(port, "PUT", "/logs/_doc/2", {"v": 2})
        assert st == 503
        assert body["error"]["type"] == "engine_failed_exception"
        stop(proc)
        proc, port = launch({})
        st, body = http(port, "GET", "/logs/_doc/1")
        assert st == 200 and body["_source"] == {"v": 1}
        st, _ = http(port, "GET", "/logs/_doc/2")
        assert st == 404
        stop(proc)
    finally:
        os.environ.clear()
        os.environ.update(env)
        if proc.poll() is None:
            proc.kill()
            proc.wait()
