"""Operation routing: which shard a document lives on.

Reference: org/elasticsearch/cluster/routing/OperationRouting.java.
"""
from __future__ import annotations

from typing import Optional

from elasticsearch_tpu_torch.utils.hashing import routing_hash


def shard_id_for(doc_id: str, num_shards: int, routing: Optional[str] = None) -> int:
    """OperationRouting.generateShardId: murmur3(routing ?: id) % shards —
    the reference's exact UTF-16LE signed murmur, so doc→shard placement
    matches ES 2.0 byte for byte."""
    key = routing if routing is not None else str(doc_id)
    return routing_hash(key) % num_shards
