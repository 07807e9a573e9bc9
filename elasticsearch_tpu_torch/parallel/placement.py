"""Shard -> device placement.

Port of elasticsearch_tpu/parallel/placement.py (reference:
org/elasticsearch/cluster/routing/allocation/, whose deciders spread
shard copies over nodes under constraints: same shard, disk, awareness).
Here the "nodes" are devices: placement is a deterministic round robin
with the same-shard constraint (a primary and its replica never land on
one device when there is more than one), the subset of deciders that
matters for a static set of devices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple


@dataclass(frozen=True)
class ShardAllocation:
    index: str
    shard_id: int
    replica: int  # 0 = primary
    device_ord: int


def allocate(index: str, n_shards: int, n_replicas: int,
             n_devices: int) -> List[ShardAllocation]:
    """Round-robin copies over devices; a replica skips its primary's device
    when possible (same-shard allocation decider)."""
    out: List[ShardAllocation] = []
    cursor = 0
    primary_dev: Dict[int, int] = {}
    for shard in range(n_shards):
        for rep in range(n_replicas + 1):
            dev = cursor % n_devices
            if rep > 0 and n_devices > 1 and dev == primary_dev[shard]:
                cursor += 1
                dev = cursor % n_devices
            if rep == 0:
                primary_dev[shard] = dev
            out.append(ShardAllocation(index, shard, rep, dev))
            cursor += 1
    return out


def placement_table(allocs: List[ShardAllocation]) -> Dict[Tuple[str, int, int], int]:
    return {(a.index, a.shard_id, a.replica): a.device_ord for a in allocs}
