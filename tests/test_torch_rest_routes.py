"""The port's REST route table against the reference's ``RestController``.

Every ``(method, pattern)`` the reference registers is registered by the
port, in the same order (the first matching route wins, so the order is
part of the table), and ``pool_for`` names the same thread pool for each
but the by-queries, which the port runs on ``bulk`` (ROADMAP C22).
No route is refused: the five of the compile/warm layer (the program
observatory and the pre-warm pipeline) and the four of the flight
recorder answer with the reference's status and keys. An unknown route
answers the reference's 400 envelope.
"""
import re

import pytest

from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu.rest.server import RestController as RefController
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.rest.server import RestController

#: the routes of the compile/warm layer (monitor/programs.py,
#: serving/warmup.py), served
WARM_ROUTES = [
    ("GET", "/_nodes/_local/xla/programs"),
    ("GET", "/_cat/programs"),
    ("POST", "/_warmup"),
    ("GET", "/_warmup"),
    ("POST", "/{index}/_warmup"),
]

#: the flight recorder's routes, served (monitor/flight.py)
FLIGHT_ROUTES = [
    ("GET", "/_nodes/_local/flight"),
    ("GET", "/_cat/incidents"),
    ("GET", "/_cluster/diagnostics"),
    ("GET", "/_cluster/diagnostics/incidents/{incident_id}"),
]


@pytest.fixture(scope="module")
def controllers():
    ref_node = RefNode(name="routes")
    port_node = Node(name="routes", device="cpu")
    yield RefController(ref_node), RestController(port_node)
    ref_node.close()
    port_node.close()


def _table(rc):
    return [(m, rc._pattern_of[rx]) for m, rx, _h in rc.routes]


def test_every_reference_route_is_registered_in_order(controllers):
    ref, port = controllers
    assert _table(port) == _table(ref)
    assert len(set(_table(port))) > 300


def test_route_regexes_agree(controllers):
    ref, port = controllers
    assert [rx.pattern for _m, rx, _h in port.routes] == \
        [rx.pattern for _m, rx, _h in ref.routes]


def _example_path(pattern: str) -> str:
    """A concrete path for a pattern: each {name} becomes a plain
    segment."""
    return re.sub(r"\{(\w+)\}", lambda m: f"x{m.group(1)}", pattern)


#: the routes whose pool differs, as (reference's, port's): a by-query
#: holds a `management` worker for its whole run in the reference, so two
#: of them starve that pool's `_tasks` cancel (ROADMAP C22)
POOL_DIFFERS = {
    ("POST", "/{index}/_delete_by_query"): ("management", "bulk"),
    ("DELETE", "/{index}/_query"): ("management", "bulk"),
    ("POST", "/{index}/_update_by_query"): ("management", "bulk"),
}


def test_pool_for_agrees_on_every_pattern(controllers):
    ref, port = controllers
    differs = {}
    for method, pattern in _table(ref):
        path = _example_path(pattern)
        want, got = ref.pool_for(method, path), port.pool_for(method, path)
        if got != want:
            differs[(method, pattern)] = (want, got)
    assert differs == POOL_DIFFERS
    # the task API and the node's health stay on `management`
    for method, path in (("GET", "/_tasks"),
                         ("POST", "/_tasks/n:1/_cancel"),
                         ("GET", "/_cluster/health")):
        assert port.pool_for(method, path) == "management"


@pytest.mark.parametrize("route", sorted(WARM_ROUTES),
                         ids=lambda r: " ".join(r))
def test_refused_route_names_its_item(controllers, route):
    """Each route of the compile/warm layer, which the port refused
    until it had the layer, answers the reference's status with the
    reference's top-level keys (an unknown index: its typed 404);
    ``_cat/programs`` rows carry the reference's columns."""
    ref, port = controllers
    method, pattern = route
    path = _example_path(pattern)
    (rs, rb), (ps, pb) = (c.dispatch(method, path, {}, b"")
                          for c in (ref, port))
    assert ps == rs
    if isinstance(rb, dict):
        assert set(pb) == set(rb)
        if rs == 404:
            assert pb["error"]["type"] == rb["error"]["type"]
    else:
        assert pb.default == rb.default


@pytest.mark.parametrize("route", FLIGHT_ROUTES, ids=lambda r: " ".join(r))
def test_flight_route_answers_as_the_reference(controllers, route):
    """Each route of the flight recorder answers the reference's status
    with the reference's top-level keys (an unknown incident: its typed
    404). ``_cat/incidents`` lists what the process persisted, which
    depends on the tests run before in it: its rows' columns are held."""
    ref, port = controllers
    method, pattern = route
    path = _example_path(pattern)
    (rs, rb), (ps, pb) = (c.dispatch(method, path, {}, b"")
                          for c in (ref, port))
    assert ps == rs
    if isinstance(rb, dict):
        assert set(pb) == set(rb)
        if rs == 404:
            assert pb["error"]["type"] == rb["error"]["type"]
    else:
        assert pb.default == rb.default
        cols = {"id", "detector", "node", "timestamp", "persisted",
                "reason"}
        assert all(set(r) == cols for r in list(pb) + list(rb))


def test_no_other_route_is_refused(controllers):
    """No route answers ``not_yet_ported_exception``: every handler is
    the route's own (none is a refusal closure)."""
    _ref, port = controllers
    refused = set()
    for method, rx, handler in port.routes:
        name = getattr(handler, "__qualname__", "")
        if "not_yet_ported" in name or "<locals>.handler" in name:
            refused.add((method, port._pattern_of[rx]))
    assert refused == set()


@pytest.mark.parametrize("method,path", [
    ("GET", "/_nope/deeper/still"), ("PATCH", "/"),
    ("DELETE", "/_cluster/health")])
def test_unknown_route_answers_the_reference_envelope(controllers, method,
                                                      path):
    ref, port = controllers
    assert port.dispatch(method, path, {}, b"") == \
        ref.dispatch(method, path, {}, b"")
