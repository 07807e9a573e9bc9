"""Helpers of the cluster differential tests (``tests/test_torch_cluster_*``).

A trio is three ``MultiHostCluster``s of one package in this process, on
loopback, with ``ping_interval=0`` so a test drives the fault-detection
rounds itself, as the reference's ``tests/unit/test_coordination_chaos.py``
builds its trio. Rank 0 binds port 0 and the joiners dial the port it
reports: no port is picked first and bound later, so parallel workers
never race for one.

``REF`` and ``PORT`` name each package's pieces, so one scenario runs
against both: the same seeded writes and bodies go to a reference trio
and a port trio.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from elasticsearch_tpu.cluster import routing as ref_routing
from elasticsearch_tpu.cluster import transport as ref_transport
from elasticsearch_tpu.cluster.bootstrap import \
    MultiHostCluster as RefCluster
from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu.utils import errors as ref_errors
from elasticsearch_tpu.utils.faults import FAULTS as REF_FAULTS
from elasticsearch_tpu_torch.cluster import routing as port_routing
from elasticsearch_tpu_torch.cluster import transport as port_transport
from elasticsearch_tpu_torch.cluster.bootstrap import \
    MultiHostCluster as PortCluster
from elasticsearch_tpu_torch.node import Node as PortNode
from elasticsearch_tpu_torch.utils import errors as port_errors
from elasticsearch_tpu_torch.utils.faults import FAULTS as PORT_FAULTS

REF = SimpleNamespace(name="ref", cluster=RefCluster,
                      node=lambda name: RefNode(name=name),
                      faults=REF_FAULTS, errors=ref_errors,
                      transport=ref_transport, routing=ref_routing)
PORT = SimpleNamespace(name="port", cluster=PortCluster,
                       node=lambda name: PortNode(name=name, device="cpu"),
                       faults=PORT_FAULTS, errors=port_errors,
                       transport=port_transport, routing=port_routing)
PACKAGES = (REF, PORT)

#: a replicated 3-shard index: every member owns one primary and one
#: replica
EVT_BODY = {"settings": {"number_of_shards": 3, "number_of_replicas": 1},
            "mappings": {"properties": {
                "n": {"type": "integer"},
                "body": {"type": "text", "analyzer": "english"},
                "tag": {"type": "keyword"}}}}

WORDS = ("alpha bravo charlie delta echo foxtrot golf hotel india juliet "
         "kilo lima mike november oscar papa quebec romeo sierra tango "
         "search engine index query shard segment score token").split()


def docs(n: int, seed: int = 7):
    """[(id, source)] with a Zipf-weighted text body, a keyword and an
    integer; made from ``seed`` with numpy."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, len(WORDS) + 1) ** 1.1
    p /= p.sum()
    out = []
    for i in range(n):
        body = " ".join(rng.choice(WORDS, size=int(rng.integers(3, 12)),
                                   p=p))
        out.append((f"d{i}", {"n": int(rng.integers(0, 1000)),
                              "body": body,
                              "tag": f"t{int(rng.integers(0, 5))}"}))
    return out


class Trio:
    """Three members of one package; ``clusters[0]`` is the bootstrap
    master."""

    def __init__(self, pkg, world: int = 3, **kw):
        self.pkg = pkg
        self.nodes = []
        self.clusters = []
        port = 0
        for rank in range(world):
            n = pkg.node(f"rank{rank}")
            c = pkg.cluster(n, rank=rank, world=world, transport_port=port,
                            ping_interval=0, **kw)
            if rank == 0:
                port = addr(c)[1]
            self.nodes.append(n)
            self.clusters.append(c)

    def __getitem__(self, i):
        return self.clusters[i]

    def close(self) -> None:
        self.pkg.faults.clear()
        for c in reversed(self.clusters):
            try:
                c.close()
            except Exception:
                pass
        for n in reversed(self.nodes):
            n.close()


def addr(c):
    host, port = c.local.transport_address.rsplit(":", 1)
    return host, int(port)


def kill(pkg, victim) -> None:
    """Every send to ``victim`` refused from now on: the deterministic
    stand-in for a dead member (``count=-1``, matched on its address)."""
    a = addr(victim)
    pkg.faults.inject("transport.send", error=ConnectionRefusedError,
                      count=-1, match=lambda ctx: ctx.get("address") == a)


def partition(pkg, minority, majority) -> None:
    """A symmetric link-level drop between ``minority`` and every member
    of ``majority``, both directions, at ``discovery.partition``."""
    min_id = minority.local.node_id
    min_addr = addr(minority)
    maj_ids = {c.local.node_id for c in majority}
    maj_addrs = {addr(c) for c in majority}
    pkg.faults.inject(
        "discovery.partition", error=ConnectionRefusedError, count=-1,
        match=lambda ctx: (
            (ctx.get("local") == min_id
             and ctx.get("address") in maj_addrs)
            or (ctx.get("local") in maj_ids
                and ctx.get("address") == min_addr)))


def rank_of(node_id: str) -> str:
    """The seat of a node id (``NNNN-<random>``): what two packages'
    trios agree on, since the random half differs."""
    return node_id.split("-", 1)[0]


def seats(obj):
    """``obj`` with every member id replaced by its seat, in keys and
    values (assignment maps, in-sync sets)."""
    if isinstance(obj, dict):
        return {seats(k): seats(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [seats(v) for v in obj]
    if isinstance(obj, str) and len(obj) > 5 and obj[4] == "-" \
            and obj[:4].isdigit():
        return obj[:4]
    return obj


def load(trio, rows, refresh: bool = True) -> None:
    """Write ``rows`` through the three coordinators in turn."""
    for i, (doc_id, src) in enumerate(rows):
        trio[i % 3].data.index_doc("evt", doc_id, src)
    if refresh:
        trio[0].data.refresh("evt")
