"""Serving front-end: cross-request micro-batching and per-tenant QoS.

Port of elasticsearch_tpu/serving/__init__.py. Each
:class:`~elasticsearch_tpu_torch.node.Node` owns one
:class:`ServingFrontend` (``node.serving``): ``Node.search`` routes
eligible single-index bodies through ``serving.coalescer``
(:mod:`coalescer`), and REST dispatch admits search-family requests
through ``serving.qos`` (:mod:`qos`, weighted tenant shares of the
node's ``in_flight_requests`` breaker). Both read the ``serving.*``
cluster settings. The reference's census pre-warm (``warmup.py``) comes
with the compile/warm layer (ROADMAP A11).
"""
from __future__ import annotations

from typing import Dict

from elasticsearch_tpu_torch.serving.coalescer import RUN_SELF, QueryCoalescer
from elasticsearch_tpu_torch.serving.qos import TenantAdmission

__all__ = ["QueryCoalescer", "RUN_SELF", "ServingFrontend",
           "TenantAdmission"]


class ServingFrontend:
    """Per-node serving layer: the coalescer, tenant QoS and their
    settings surface."""

    def __init__(self, node):
        self.coalescer = QueryCoalescer(node)
        self.qos = TenantAdmission(node.breakers, node.metrics)

    def apply_cluster_settings(self, flat: Dict[str, object]) -> None:
        self.coalescer.apply_cluster_settings(flat)
        self.qos.apply_cluster_settings(flat)

    def stats(self) -> dict:
        return {"coalescer": self.coalescer.stats(), "qos": self.qos.stats()}

    def close(self) -> None:
        self.coalescer.close()
