"""Harness of the REST differential tests (``tests/test_torch_rest_*.py``).

A reference ``RestServer`` over a JAX-package ``Node`` and the port's
``RestServer`` over ``Node(device="cpu")`` listen on 127.0.0.1, each on a
port of its own (port 0 at bind). :meth:`Pair.both` sends one HTTP request
to each and returns both answers; :meth:`Pair.wipe` resets both between
cases as the REST-spec YAML runner's ``_wipe`` does, and also zeroes the
reference's process-wide breakers, what they hold and their trip
counters (ROADMAP C20).

What must match:

- exactly: the status, the error ``type``, hit ids and their order,
  ``hits.total``, ``_version``, ``found``, ``_shards``, bulk item
  statuses and aggregation buckets (:func:`same`, which also compares
  every other key);
- scores: within the tolerance of the existing parity test of that path
  (:data:`SCORE_RTOL`);
- nothing of :data:`MASKED`, whose values are volatile.

:func:`same_as_in_process` holds the port's HTTP answer byte for byte
against the port's own in-process answer for the same body, after
masking ``took``: the REST layer adds no arithmetic.
"""
from __future__ import annotations

import copy
import json
import math
import re
import urllib.error
import urllib.request
from typing import Any, Dict, Optional, Tuple

from elasticsearch_tpu import resources as ref_resources
from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu.rest.server import RestServer as RefServer
from elasticsearch_tpu_torch.node import Node as PortNode
from elasticsearch_tpu_torch.rest.server import RestServer as PortServer
from elasticsearch_tpu_torch.rest.server import _json_default

#: volatile values, each with why; their keys are compared, not their values
MASKED: Dict[str, str] = {
    "took": "wall-clock milliseconds of the request",
    "timestamp": "the wall clock at the answer",
    "epoch": "the wall clock at the answer (_cat)",
    "start_time_in_millis": "the wall clock at a task's or a "
                            "recovery's start",
    "running_time_in_nanos": "a task's age at the answer",
    "running_time": "a task's age at the answer",
    "total_time_in_millis": "a recovery's wall time",
    "time": "a recovery's wall time (_cat/recovery)",
    "creation_date": "the wall clock at an index's creation",
    "uuid": "random per index",
    "state_uuid": "random per cluster-state version",
    "index_uuid": "random per index",
    "master_node": "node ids are random per process",
    "node": "node ids are random per process",
    "node_id": "node ids are random per process",
    "id": "node ids in _cat rows are random per process",
    "_node": "node ids are random per process",
    "_scroll_id": "an opaque handle, random per scroll",
    "scroll_id": "an opaque handle, random per scroll",
    "task_id": "an opaque task id (node id : sequence)",
    "parent_task_id": "an opaque task id (node id : sequence)",
    "process": "the serving process's own numbers",
    "os": "the host's numbers at the answer",
    "jvm": "the serving process's resident set",
    "accelerator": "the device section: a TPU against a CPU tensor",
    "heap.current": "the serving process's resident set (_cat)",
    "heap.max": "the serving process's resident set (_cat)",
    "ram.current": "the serving process's resident set (_cat)",
    "ram.max": "the serving process's resident set (_cat)",
    "pid": "the serving process's id (_cat)",
    "file_desc.current": "the serving process's open files (_cat)",
    "disk.used": "the host's disk at the answer (_cat/allocation)",
    "disk.avail": "the host's disk at the answer (_cat/allocation)",
    "disk.total": "the host's disk at the answer (_cat/allocation)",
    "disk.percent": "the host's disk at the answer (_cat/allocation)",
}

#: key suffixes whose values are wall-clock durations (``*_in_millis``
#: times of stats sections, ``*_nanos`` of profiles and tasks)
MASKED_SUFFIXES = ("time_in_millis", "_nanos")

#: per search path, the score bar of its existing parity test
SCORE_RTOL = {
    # tests/test_torch_slice.py::_check_generic (scatter sums may run in
    # another order)
    "generic": 1e-5,
    # tests/test_torch_slice.py, fused bodies: the port computes B1's
    # bf16 product where the reference's CPU fallback is an f32 one
    "fused": 5e-3,
    # tests/test_torch_slice.py -k knn: brute-force kNN on both
    "knn": 1e-5,
}

#: inside ``aggregations``, the bar of tests/test_torch_aggs.py::_same:
#: keys, counts, min and max exact, other floats (f32 sums taken in
#: another order) at this rtol
AGG_RTOL = 1e-5
AGG_EXACT_KEYS = {"key", "key_as_string", "doc_count", "count", "min", "max",
                  "from", "to", "bg_count", "sum_other_doc_count",
                  "doc_count_error_upper_bound", "total", "_id", "_source",
                  "_score"}


def http(port: int, method: str, path: str, body: Any = None,
         ndjson: Optional[str] = None,
         headers: Optional[dict] = None) -> Tuple[int, Any]:
    """One request; the answer parsed as JSON when it is JSON, else its
    text (``_cat`` tables, hot threads, the metrics exposition)."""
    status, raw, ctype = http_raw(port, method, path, body, ndjson, headers)
    if not raw:
        return status, None
    if ctype.startswith("application/json"):
        return status, json.loads(raw)
    return status, raw.decode()


def http_raw(port: int, method: str, path: str, body: Any = None,
             ndjson: Optional[str] = None,
             headers: Optional[dict] = None) -> Tuple[int, bytes, str]:
    data = None
    hdrs = {"Content-Type": "application/json"}
    if ndjson is not None:
        data = ndjson.encode()
        hdrs["Content-Type"] = "application/x-ndjson"
    elif body is not None:
        data = body if isinstance(body, bytes) else json.dumps(body).encode()
    hdrs.update(headers or {})
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method=method, headers=hdrs)
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return (resp.status, resp.read(),
                    resp.headers.get("Content-Type", ""))
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type", "")


def ndjson(lines) -> str:
    return "".join(json.dumps(x) + "\n" for x in lines)


class Pair:
    """The two servers, and what each answered."""

    def __init__(self, watchdog_interval_s: Optional[float] = None):
        """``watchdog_interval_s``: each watchdog's tick interval, set
        before the servers start their tick threads (a test that drives
        the ticks itself passes one longer than it runs)."""
        self.ref = RefNode(name="rest-node")
        self.port = PortNode(name="rest-node", device="cpu")
        if watchdog_interval_s is not None:
            for node in (self.ref, self.port):
                node.watchdog.config["interval_s"] = watchdog_interval_s
        self.ref_server = RefServer(self.ref, host="127.0.0.1", port=0)
        self.port_server = PortServer(self.port, host="127.0.0.1", port=0)
        self.ref_server.start(background=True)
        self.port_server.start(background=True)

    def both(self, method: str, path: str, body: Any = None,
             ndjson: Optional[str] = None,
             headers: Optional[dict] = None):
        """(reference answer, port answer), each ``(status, payload)``."""
        r = http(self.ref_server.port, method, path, copy.deepcopy(body),
                 ndjson, headers)
        p = http(self.port_server.port, method, path, copy.deepcopy(body),
                 ndjson, headers)
        return r, p

    def same(self, method: str, path: str, body: Any = None,
             ndjson: Optional[str] = None, scores: str = "generic",
             ignore=()) -> Tuple[Any, Any]:
        """Send to both and hold the answers equal (:func:`same`);
        returns the two payloads."""
        (rs, rb), (ps, pb) = self.both(method, path, body, ndjson)
        assert ps == rs, (method, path, rs, rb, ps, pb)
        same(node_ids_out(rb, self.ref.node_id),
             node_ids_out(pb, self.port.node_id),
             rtol=SCORE_RTOL[scores], ignore=ignore,
             where=f"{method} {path}")
        return rb, pb

    def wipe(self) -> None:
        for node in (self.ref, self.port):
            for name in list(node.indices):
                node.delete_index(name)
            node.cluster_state.templates.clear()
            node.repositories.clear()
            node.search_templates.clear()
            node.search_template_versions.clear()
            for scope in node.cluster_settings.values():
                scope.clear()
            node.serving.apply_cluster_settings({})
        ref_resources.apply_cluster_settings({})
        self.port.breakers.apply_cluster_settings({})
        # the reference's breakers are the process's: zero what other
        # nodes of the process (earlier files in this worker) charged and
        # tripped, so none of it reaches a compared answer
        for name in ("fielddata", "request", "in_flight_requests",
                     "segments"):
            ref_resources.BREAKERS.breaker(name).used = 0
            ref_resources.BREAKERS.breaker(name).trip_count = 0
        ref_resources.BREAKERS.parent_tripped = 0
        from elasticsearch_tpu.search import scripting as ref_scripting
        from elasticsearch_tpu_torch.search import scripting as port_scripting

        for mod in (ref_scripting, port_scripting):
            if hasattr(mod, "_STORED"):
                mod._STORED.clear()

    def close(self) -> None:
        for srv, node in ((self.ref_server, self.ref),
                          (self.port_server, self.port)):
            srv.stop()
            node.close()


def node_ids_out(obj: Any, node_id: str) -> Any:
    """``obj`` with its node's id, random per process, replaced in keys
    and string values (``nodes`` maps, tagged task ids ``node:seq``,
    search shards)."""
    if isinstance(obj, dict):
        return {node_ids_out(k, node_id): node_ids_out(v, node_id)
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [node_ids_out(v, node_id) for v in obj]
    if isinstance(obj, str) and node_id in obj:
        return obj.replace(node_id, "<node id>")
    return obj


def masked(obj: Any, ignore=()) -> Any:
    """``obj`` with every :data:`MASKED` value replaced by a marker (the
    key stays) and every key in ``ignore`` left out (a caller names what
    one side alone carries, and why)."""
    if isinstance(obj, dict):
        return {k: ("<masked>" if k in MASKED or k.endswith(MASKED_SUFFIXES)
                    else masked(v, ignore))
                for k, v in obj.items() if k not in ignore}
    if isinstance(obj, list):
        return [masked(v, ignore) for v in obj]
    return obj


_SCORE_KEYS = {"_score", "max_score"}


def same(ref: Any, port: Any, rtol: float = 1e-5, ignore=(),
         where: str = "") -> None:
    """Deep equality after :func:`masked`. A float under a score key
    (``_score``, ``max_score``) compares at ``rtol``, and one inside
    ``aggregations`` but outside :data:`AGG_EXACT_KEYS` at
    :data:`AGG_RTOL`; every other value, ids, totals, versions, bucket
    keys and counts among them, compares exactly."""
    _same(masked(ref, ignore), masked(port, ignore), rtol, where or "$")


def _same(r: Any, p: Any, rtol: float, path: str, key: str = "",
          agg: bool = False) -> None:
    if isinstance(r, dict) and isinstance(p, dict):
        assert set(r) == set(p), (path, sorted(set(r) ^ set(p)))
        for k in r:
            _same(r[k], p[k], rtol, f"{path}.{k}", k,
                  agg or k == "aggregations")
        return
    if isinstance(r, list) and isinstance(p, list):
        assert len(r) == len(p), (path, len(r), len(p))
        for i, (a, b) in enumerate(zip(r, p)):
            _same(a, b, rtol, f"{path}[{i}]", key, agg)
        return
    if (agg and key not in AGG_EXACT_KEYS and isinstance(r, float)
            and isinstance(p, float)):
        assert math.isclose(r, p, rel_tol=AGG_RTOL), (path, r, p)
        return
    if (key in _SCORE_KEYS and isinstance(r, float)
            and isinstance(p, (int, float)) and not isinstance(p, bool)):
        assert math.isclose(r, p, rel_tol=rtol, abs_tol=1e-12), (path, r, p)
        return
    assert r == p and type(r) is type(p), (path, r, p)


def ids(resp: dict) -> list:
    return [h["_id"] for h in resp["hits"]["hits"]]


def same_as_in_process(pair: Pair, raw: bytes, index: Optional[str],
                       body: dict, msearch: bool = False) -> None:
    """The port's HTTP answer (``raw``) against the port's own
    ``Node.search`` / ``Node.msearch`` answer to the same body, byte for
    byte once ``took`` is masked on both."""
    if msearch:
        got = pair.port.msearch(copy.deepcopy(body))
    else:
        got = pair.port.search(index, copy.deepcopy(body))
    want = json.dumps(got, default=_json_default).encode()
    took = re.compile(rb'"took": \d+')
    assert took.sub(b'"took": 0', raw) == took.sub(b'"took": 0', want)
