"""The shard "mesh" on one card.

Port of elasticsearch_tpu/parallel/mesh.py's ``shard_mesh`` and
``mesh_size``. The reference lays shards over a ``('shard',)`` device
mesh and merges with collectives. On one H100 the mesh is S slots of the
one device: a slot's data is its segment's own tensors (or a row of a
slot-stacked ``[S, ...]`` tensor), ``all_gather`` is the stacked
per-slot ``[S, k]`` result and ``psum`` a sum over the slot dimension.
``training_mesh`` comes with the models (ROADMAP A12).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class ShardMesh:
    """S shard slots on one device."""

    device: torch.device
    slots: int


def shard_mesh(n_shards: int, device) -> ShardMesh:
    """One slot per shard, all on ``device``."""
    if n_shards < 1:
        raise ValueError(f"a mesh needs at least one slot, got {n_shards}")
    return ShardMesh(torch.device(device), int(n_shards))


def mesh_size(mesh: ShardMesh) -> int:
    return mesh.slots
