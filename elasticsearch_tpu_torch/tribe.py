"""Tribe node: a documented stub.

Port of elasticsearch_tpu/tribe.py (reference:
org/elasticsearch/tribe/TribeService.java, where a tribe node joins
several clusters as a read-only member and merges their cluster states).
The cluster layer (cluster/bootstrap.py) runs one cluster; federating
several is out of scope, and this module says so instead of
half-working.

``TribeNode.search_remote`` fans a search out to a list of REST
endpoints over the port's HTTP client (client.py) and merges the hit
lists by score, the read-only core of the tribe use; cluster-state
federation raises NotImplementedError with the reference pointer.
"""
from __future__ import annotations

from typing import Dict, List

from elasticsearch_tpu_torch.client import Client


class TribeNode:
    def __init__(self, endpoints: List[str]):
        self.clients = [Client(url=url) for url in endpoints]

    def search_remote(self, index: str, body: dict, size: int = 10) -> dict:
        """Scatter a search to every remote cluster, merge by _score. Each
        remote is asked for the full merged window — a cluster's 11th-best
        hit may be the tribe's 3rd."""
        hits: List[dict] = []
        total = 0
        # one window everywhere: what we ask each remote for is what the
        # caller gets back (size param or body size, whichever is larger)
        size = max(size, int(body.get("size", 10)))
        remote_body = {**body, "size": size}
        for c in self.clients:
            r = c.search(index=index, body=remote_body)
            total += r["hits"]["total"]
            hits.extend(r["hits"]["hits"])
        hits.sort(key=lambda h: -(h.get("_score") or 0.0))
        return {"hits": {"total": total, "hits": hits[:size]}}

    def merged_cluster_state(self) -> Dict:
        raise NotImplementedError(
            "tribe cluster-state federation is not implemented (reference: "
            "tribe/TribeService.java — on-conflict index preference, merged "
            "routing); use search_remote for the read-only fan-out")
