"""Serving front-end: cross-request micro-batching.

Port of elasticsearch_tpu/serving/__init__.py, slim: each
:class:`~elasticsearch_tpu_torch.node.Node` owns one
:class:`ServingFrontend` (``node.serving``), and ``Node.search`` routes
eligible single-index bodies through ``serving.coalescer``
(:mod:`coalescer`). The reference's per-tenant QoS (``qos.py``, whose
one caller is REST dispatch) comes with the REST layer (ROADMAP A10e) and
its census pre-warm (``warmup.py``) with the compile/warm layer (A11).
"""
from __future__ import annotations

from typing import Dict

from elasticsearch_tpu_torch.serving.coalescer import RUN_SELF, QueryCoalescer

__all__ = ["QueryCoalescer", "RUN_SELF", "ServingFrontend"]


class ServingFrontend:
    """Per-node serving layer: the coalescer and its settings surface."""

    def __init__(self, node):
        self.coalescer = QueryCoalescer(node)

    def apply_cluster_settings(self, flat: Dict[str, object]) -> None:
        self.coalescer.apply_cluster_settings(flat)

    def stats(self) -> dict:
        return {"coalescer": self.coalescer.stats()}

    def close(self) -> None:
        self.coalescer.close()
