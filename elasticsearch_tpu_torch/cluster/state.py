"""Cluster state: nodes, index metadata, the routing table, templates.

Port of the single-node part of elasticsearch_tpu/cluster/state.py: the
index metadata (settings, mappings, aliases, open or closed), the index
templates, one routing entry a shard, health, and the state's JSON that
``GET /_cluster/state`` serves. The master's term and global blocks (the
no-master write block), elections and publication come with the
multi-node layer (ROADMAP A10f): one node is never re-elected and never
headless, so its JSON carries term 0 and no blocks.
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
        self.state_uuid = uuid.uuid4().hex
        self.nodes: Dict[str, DiscoveryNode] = {}
        self.master_node_id: Optional[str] = None
        self.indices: Dict[str, IndexMetadata] = {}
        self.routing: List[ShardRouting] = []
        self.templates: Dict[str, dict] = {}

    def next_version(self) -> None:
        self.version += 1
        self.state_uuid = uuid.uuid4().hex

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
            "term": 0,
            "state_uuid": self.state_uuid,
            "master_node": self.master_node_id,
            "blocks": {},
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
