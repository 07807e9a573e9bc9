"""Cluster state: nodes, index metadata, the routing table, templates.

Port of elasticsearch_tpu/cluster/state.py: the index metadata
(settings, mappings, aliases, open or closed), the index templates, one
routing entry a shard, health, and the state's JSON that ``GET
/_cluster/state`` serves; with the cluster (cluster/bootstrap.py) the
master's term, bumped by every quorum election, and the global blocks
(the no-master write block). A master publishes versioned states:
(term, version) orders them across master changes.
"""
from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class DiscoveryNode:
    node_id: str
    name: str
    transport_address: str = "local"
    roles: tuple = ("master", "data", "ingest")
    attributes: dict = field(default_factory=dict)


#: ES's NO_MASTER_BLOCK at write level (reference: DiscoverySettings
#: .NO_MASTER_BLOCK_WRITES / NoMasterBlockService): with no elected
#: master, metadata changes and document writes fail typed 503 while
#: searches keep serving the last committed state.
NO_MASTER_BLOCK = {
    "id": 2,
    "description": "no master",
    "retryable": True,
    "levels": ["write", "metadata_write"],
}


@dataclass
class ShardRouting:
    index: str
    shard_id: int
    node_id: str
    primary: bool = True
    state: str = "STARTED"  # INITIALIZING|RELOCATING|STARTED|UNASSIGNED


@dataclass
class IndexMetadata:
    name: str
    settings: dict
    mappings: dict
    aliases: Dict[str, dict] = field(default_factory=dict)
    state: str = "open"
    creation_date: int = field(default_factory=lambda: int(time.time() * 1000))
    uuid: str = field(default_factory=lambda: uuid.uuid4().hex)


class ClusterState:
    def __init__(self, cluster_name: str = "elasticsearch_tpu"):
        self.cluster_name = cluster_name
        self.version = 0
        # the master's era, bumped by every quorum election: publications
        # of an older term are stale and rejected
        self.term = 0
        self.state_uuid = uuid.uuid4().hex
        self.nodes: Dict[str, DiscoveryNode] = {}
        self.master_node_id: Optional[str] = None
        self.indices: Dict[str, IndexMetadata] = {}
        self.routing: List[ShardRouting] = []
        self.templates: Dict[str, dict] = {}
        self.blocks: Dict[str, list] = {}

    def next_version(self) -> None:
        self.version += 1
        self.state_uuid = uuid.uuid4().hex

    # -- global blocks -------------------------------------------------------

    def add_global_block(self, block: dict) -> None:
        blocks = self.blocks.setdefault("global", [])
        if all(b.get("id") != block.get("id") for b in blocks):
            blocks.append(dict(block))

    def clear_global_block(self, block_id: int) -> None:
        blocks = self.blocks.get("global")
        if blocks:
            blocks[:] = [b for b in blocks if b.get("id") != block_id]

    def global_block(self, level: str) -> Optional[dict]:
        """The first global block covering ``level``, or None."""
        for b in self.blocks.get("global", []):
            if level in b.get("levels", []):
                return b
        return None

    def add_node(self, node: DiscoveryNode, master: bool = False) -> None:
        self.nodes[node.node_id] = node
        if master or self.master_node_id is None:
            self.master_node_id = node.node_id
        self.next_version()

    def add_index(self, meta: IndexMetadata, num_shards: int,
                  node_id: str) -> None:
        self.indices[meta.name] = meta
        self.routing.extend(ShardRouting(meta.name, sid, node_id)
                            for sid in range(num_shards))
        self.next_version()

    def remove_index(self, name: str) -> None:
        self.indices.pop(name, None)
        self.routing = [r for r in self.routing if r.index != name]
        self.next_version()

    def health(self) -> dict:
        unassigned = sum(1 for r in self.routing if r.state == "UNASSIGNED")
        initializing = sum(1 for r in self.routing
                           if r.state == "INITIALIZING")
        active = sum(1 for r in self.routing if r.state == "STARTED")
        status = "green"
        if unassigned or initializing:
            status = "yellow" if active else "red"
        return {
            "cluster_name": self.cluster_name,
            "status": status,
            "timed_out": False,
            "number_of_nodes": len(self.nodes),
            "number_of_data_nodes": sum(1 for n in self.nodes.values()
                                        if "data" in n.roles),
            "active_primary_shards": sum(1 for r in self.routing
                                         if r.primary
                                         and r.state == "STARTED"),
            "active_shards": active,
            "relocating_shards": sum(1 for r in self.routing
                                     if r.state == "RELOCATING"),
            "initializing_shards": initializing,
            "unassigned_shards": unassigned,
        }

    def to_json(self) -> dict:
        return {
            "cluster_name": self.cluster_name,
            "version": self.version,
            "term": self.term,
            "state_uuid": self.state_uuid,
            "master_node": self.master_node_id,
            "blocks": {k: list(v) for k, v in self.blocks.items() if v},
            "nodes": {
                nid: {"name": n.name, "transport_address": n.transport_address,
                      "roles": list(n.roles)}
                for nid, n in self.nodes.items()
            },
            "metadata": {
                "templates": self.templates,
                "indices": {
                    name: {
                        "state": m.state,
                        "settings": m.settings,
                        "mappings": m.mappings,
                        "aliases": list(m.aliases),
                    }
                    for name, m in self.indices.items()
                },
            },
            "routing_table": {
                "indices": {
                    name: {
                        "shards": {
                            str(r.shard_id): [{
                                "state": r.state, "primary": r.primary,
                                "node": r.node_id, "shard": r.shard_id,
                                "index": r.index,
                            }]
                            for r in self.routing if r.index == name
                        }
                    }
                    for name in self.indices
                }
            },
        }
