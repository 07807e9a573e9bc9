"""Serving front-end: cross-request micro-batching and per-tenant QoS.

Port of elasticsearch_tpu/serving/__init__.py. Each
:class:`~elasticsearch_tpu_torch.node.Node` owns one
:class:`ServingFrontend` (``node.serving``): ``Node.search`` routes
eligible single-index bodies through ``serving.coalescer``
(:mod:`coalescer`), and REST dispatch admits search-family requests
through ``serving.qos`` (:mod:`qos`, weighted tenant shares of the
node's ``in_flight_requests`` breaker), and ``serving.warmup``
(:mod:`warmup`) replays an index's persisted census before traffic
arrives. All three read the ``serving.*`` cluster settings.
"""
from __future__ import annotations

from typing import Dict

from elasticsearch_tpu_torch.serving.coalescer import RUN_SELF, QueryCoalescer
from elasticsearch_tpu_torch.serving.qos import TenantAdmission
from elasticsearch_tpu_torch.serving.warmup import WarmupService

__all__ = ["QueryCoalescer", "RUN_SELF", "ServingFrontend",
           "TenantAdmission", "WarmupService"]


class ServingFrontend:
    """Per-node serving layer: the coalescer, tenant QoS, the pre-warm
    service and their settings surface."""

    def __init__(self, node):
        self.coalescer = QueryCoalescer(node)
        self.qos = TenantAdmission(node.breakers, node.metrics)
        self.warmup = WarmupService(node)

    def apply_cluster_settings(self, flat: Dict[str, object]) -> None:
        self.coalescer.apply_cluster_settings(flat)
        self.qos.apply_cluster_settings(flat)
        self.warmup.apply_cluster_settings(flat)

    def stats(self) -> dict:
        return {"coalescer": self.coalescer.stats(), "qos": self.qos.stats(),
                "warmup": self.warmup.stats()}

    def close(self) -> None:
        # the warmup worker drives searches through the coalescer's path:
        # it stops producing before the coalescer drains
        self.warmup.close()
        self.coalescer.close()
