"""The port's serving coalescer (``serving/coalescer.py``) under real
threads, without REST: concurrent single searches through
``Node.search`` run as one batch (``search/batch.py``) and answer what
sequential searches answer; a lone request, ``enabled: false`` and
``mode: off`` bypass the queue; ``close()`` drains parked requests; a
body the coalescer cannot batch gives the sequential path's answer or
typed error.

The corpus is ``tests/unit/test_serving.py``'s, with the dense-block df
bar dropped to 8 so that its head words have dense rows. Every wait has
its own timeout.
"""
import copy
import functools
import threading
import time

import numpy as np
import pytest

from elasticsearch_tpu_torch.monitor import kernels
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.utils.errors import QueryParsingException

HEAD = ["alpha", "beta", "gamma", "delta"]
WAIT_S = 60.0


def _make_node():
    """``co``: two shards on the mesh (the default); ``ch``: the same
    documents pinned to the host tiers."""
    n = Node(device="cpu")
    for name, idx in (("co", {"number_of_shards": 2}),
                      ("ch", {"number_of_shards": 2,
                              "search": {"mesh": "false"}})):
        n.create_index(name, {"settings": {"index": idx},
                              "mappings": {"properties": {
                                  "body": {"type": "text"}}}})
        rng = np.random.default_rng(11)
        for i in range(120):
            words = list(rng.choice(HEAD, size=6)) + [f"rare{i % 23}"]
            n.index(name, str(i), {"body": " ".join(words)})
        n.refresh(name)
    return n


@pytest.fixture(scope="module")
def node():
    from elasticsearch_tpu_torch.index import segment as segmod

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(segmod, "build_dense_impact", functools.partial(
            segmod.build_dense_impact, df_threshold=8))
        n = _make_node()
        for name in ("co", "ch"):
            n.search(name, {"query": {"match": {"body": "alpha"}}})
        yield n
    n.close()


def _settings(n, **kv):
    """Serving settings through the one idempotent full-map path."""
    n.serving.apply_cluster_settings(
        {f"serving.coalescer.{k}": v for k, v in kv.items()})


def _sig(resp):
    return [(h["_id"], h["_score"]) for h in resp["hits"]["hits"]], \
        resp["hits"]["total"]


def _body(q, size=7):
    return {"query": {"match": {"body": q}}, "size": size}


QUERIES = [" ".join(p) for p in
           [("alpha",), ("beta", "gamma"), ("alpha", "delta"), ("gamma",),
            ("delta", "beta"), ("alpha", "beta", "gamma"), ("beta",),
            ("delta",)]] * 2


def _concurrent(n, bodies, index="co"):
    """Every body from its own thread, released together; the responses
    (or errors) in order."""
    out = [None] * len(bodies)
    barrier = threading.Barrier(len(bodies))

    def client(i):
        try:
            barrier.wait(timeout=WAIT_S)
            out[i] = n.search(index, copy.deepcopy(bodies[i]))
        except Exception as e:  # surfaced below
            out[i] = e

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
        assert not t.is_alive(), "a client did not finish"
    return out


def _agree(got, want, rtol):
    (gh, gt), (wh, wt) = _sig(got), _sig(want)
    assert gt == wt and [h for h, _ in gh] == [h for h, _ in wh]
    np.testing.assert_allclose([v for _, v in gh], [v for _, v in wh],
                               rtol=rtol, atol=0)


def _fused_bar(got, want):
    (gh, gt), (wh, wt) = _sig(got), _sig(want)
    assert gt == wt and len(gh) == len(wh)
    np.testing.assert_allclose([v for _, v in gh], [v for _, v in wh],
                               rtol=5e-3)


def _sequential(n, index, bodies):
    """Each body's sequential response, and whether B1 served any of its
    segments (a shard where a rare term is absent is pure-dense)."""
    out = []
    for b in bodies:
        kernels.reset()
        r = n.search(index, copy.deepcopy(b))
        out.append((r, bool(kernels.snapshot().get("bm25_fused_topk"))))
    return out


# (index, tail terms, counter of the batch's route, bar against the
# sequential path): the host tiers' tier 1 runs B1's batched form, whose
# sums are the rows form's (rtol 0); tier 2 and the mesh round score in
# f32, against the sequential generic route's own f32 order (rtol 1e-5),
# and against B1's bf16 at the fused-path bar where B1 served a segment
ROUTES = [("ch", False, "bm25_fused_topk", 0.0),
          ("ch", True, "bm25_hybrid", 1e-5),
          ("co", True, "mesh_msearch", 1e-5)]


@pytest.mark.parametrize("index,tail,counter,rtol", ROUTES)
def test_concurrent_searches_coalesce(node, index, tail, counter, rtol):
    """Batches larger than one, every response what a sequential search
    answers."""
    qs = [q + (f" rare{i % 23}" if tail else "")
          for i, q in enumerate(QUERIES)]
    bodies = [_body(q) for q in qs]
    want = _sequential(node, index, bodies)
    before = node.serving.coalescer.stats()["batch_size"]
    _settings(node, mode="always", max_wait="200ms", idle_gap="50ms")
    kernels.reset()
    try:
        got = _concurrent(node, bodies, index)
    finally:
        _settings(node)
    snap = kernels.snapshot()
    for g, (w, b1) in zip(got, want):
        assert not isinstance(g, Exception), g
        if b1 and rtol:
            _fused_bar(g, w)
        else:
            _agree(g, w, rtol)
    after = node.serving.coalescer.stats()["batch_size"]
    assert after["count"] > before["count"]
    assert after["max"] > 1
    assert snap.get(counter, 0) >= 1, snap


def test_coalesced_pure_dense_on_the_mesh(node):
    """Pure-dense bodies on a mesh index: the batch's postings round is
    f32 where the sequential path's B1 rounds to bf16, so they agree at
    the fused-path bar (rtol 5e-3, exact totals)."""
    bodies = [_body(q) for q in QUERIES]
    want = _sequential(node, "co", bodies)
    _settings(node, mode="always", max_wait="200ms", idle_gap="50ms")
    try:
        got = _concurrent(node, bodies)
    finally:
        _settings(node)
    for g, (w, b1) in zip(got, want):
        assert b1
        _fused_bar(g, w)


def test_solo_request_bypasses_the_queue(node):
    st = node.serving.coalescer.stats()
    r = node.search("co", _body("alpha", 5))
    assert r["hits"]["total"] > 0
    st2 = node.serving.coalescer.stats()
    assert st2["bypass"].get("solo", 0) == st["bypass"].get("solo", 0) + 1
    assert st2["batch_size"]["count"] == st["batch_size"]["count"]


@pytest.mark.parametrize("setting", [{"enabled": "false"}, {"mode": "off"}])
def test_disabled_or_off_bypasses(node, setting):
    _settings(node, **setting)
    try:
        st = node.serving.coalescer.stats()
        got = _concurrent(node, [_body(q) for q in QUERIES[:4]])
        st2 = node.serving.coalescer.stats()
    finally:
        _settings(node)
    assert all(not isinstance(g, Exception) for g in got)
    # fully off: not even the solo gate runs
    assert st2["bypass"] == st["bypass"]
    assert st2["batch_size"] == st["batch_size"]


def test_env_switch_disables(monkeypatch):
    from types import SimpleNamespace

    from elasticsearch_tpu_torch.monitor.metrics import MetricsRegistry
    from elasticsearch_tpu_torch.serving.coalescer import QueryCoalescer

    monkeypatch.setenv("ESTPU_COALESCER", "0")
    # the switch is read at construction: a stub node with a registry
    c = QueryCoalescer(SimpleNamespace(metrics=MetricsRegistry()))
    assert not c.enabled
    c.apply_cluster_settings({"serving.coalescer.enabled": "true"})
    assert c.enabled
    c.apply_cluster_settings({})
    assert not c.enabled


def test_close_drains_parked_requests():
    n = _make_node()
    body = _body("alpha beta")
    want = n.search("co", copy.deepcopy(body))
    # a window no flush reaches: the request stays parked until close
    _settings(n, mode="always", max_wait="30s", idle_gap="30s")
    out = {}
    t = threading.Thread(target=lambda: out.setdefault(
        "r", n.search("co", copy.deepcopy(body))))
    t.start()
    deadline = time.perf_counter() + WAIT_S
    while n.serving.coalescer.stats()["queued"] < 1:
        assert time.perf_counter() < deadline, "the request never parked"
        time.sleep(0.01)
    n.close()
    t.join(timeout=WAIT_S)
    assert not t.is_alive()
    assert _sig(out["r"]) == _sig(want)


@pytest.mark.parametrize("bad", ["profile", "unknown_query"])
def test_unbatchable_body_gives_the_sequential_typed_error(node, bad):
    """A body no batch takes answers as the sequential path does: a
    ``profile`` body parks and runs alone at the flush (its response, with
    the coalescer's profile section), an unknown query gives the typed
    error."""
    if bad == "profile":
        body = dict(_body("alpha"), profile=True)
        seq = node.get_index("co").search(copy.deepcopy(body))
    else:
        body = {"query": {"no_such_query": {}}}
        with pytest.raises(QueryParsingException) as err:
            node.get_index("co").search(copy.deepcopy(body))
    _settings(node, mode="always", max_wait="20ms", idle_gap="5ms")
    try:
        got = _concurrent(node, [body, body, _body("gamma")])
    finally:
        _settings(node)
    for g in got[:2]:
        if bad == "profile":
            assert _sig(g) == _sig(seq)
            assert g["profile"]["coalescer"]["batch_size"] == 1
        else:
            assert type(g) is QueryParsingException \
                and str(g) == str(err.value)
    assert got[2]["hits"]["total"] > 0


def test_a_batch_failure_reaches_every_waiter(node, monkeypatch):
    """No fallback hides a failure of the batch: each parked request of
    the batch raises it."""
    from elasticsearch_tpu_torch.search import batch

    def boom(*a, **kw):
        raise RuntimeError("device fault")

    monkeypatch.setattr(batch, "execute_batch", boom)
    _settings(node, mode="always", max_wait="200ms", idle_gap="50ms")
    try:
        got = _concurrent(node, [_body(q) for q in QUERIES[:6]])
    finally:
        _settings(node)
    assert all(isinstance(g, RuntimeError) for g in got), got
    assert node.serving.coalescer.stats()["bypass"].get("batch_error")


def test_stats_shape(node):
    st = node.serving.stats()["coalescer"]
    assert {"enabled", "mode", "queued", "buckets", "max_batch",
            "max_wait_ms", "batch_size", "flushes", "bypass"} <= set(st)
    assert set(st["batch_size"]["le"]) == {1, 2, 4, 8, 16, 32, 64, 128,
                                           256, 512}
