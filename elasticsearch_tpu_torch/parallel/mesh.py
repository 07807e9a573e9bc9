"""The shard "mesh" and the training mesh on one card.

Port of elasticsearch_tpu/parallel/mesh.py's ``shard_mesh``,
``training_mesh`` and ``mesh_size``. The reference lays shards over a
``('shard',)`` device mesh and merges with collectives. On one H100 the
mesh is S slots of the one device: a slot's data is its segment's own
tensors (or a row of a slot-stacked ``[S, ...]`` tensor), ``all_gather``
is the stacked per-slot ``[S, k]`` result and ``psum`` a sum over the
slot dimension.

The models' meshes are slots of one device too. ``training_mesh`` keeps
the reference's ``('dp', 'tp')`` factorisation, which decides the batch
divisibility and the tensor-parallel specs of
``models/dual_encoder.py::param_shardings``; the train step itself runs
whole on the device, so there is no all-reduce to insert and a step
under any factorisation is the same computation. The ring encoder's
``('sp',)`` axis is a ``ShardMesh`` of sequence slots
(``models/ring_encoder.py::build_sp_mesh``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from elasticsearch_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class ShardMesh:
    """S slots (shards, or a sequence's blocks) on one device."""

    device: torch.device
    slots: int


def shard_mesh(n_shards: int, device) -> ShardMesh:
    """One slot per shard, all on ``device``."""
    if n_shards < 1:
        raise ValueError(f"a mesh needs at least one slot, got {n_shards}")
    return ShardMesh(torch.device(device), int(n_shards))


@dataclass(frozen=True)
class TrainingMesh:
    """``dp x tp`` slots of one device: the reference's 2-D
    ``('dp', 'tp')`` mesh as data."""

    device: torch.device
    dp: int
    tp: int

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "tp": self.tp}


def training_mesh(n_devices: int = 1, device=None,
                  tp: Optional[int] = None) -> TrainingMesh:
    """``('dp', 'tp')`` slots of one device.

    tp defaults to the largest power of two <= min(n, 4) that divides n,
    the reference's rule: tensor-parallel groups stay small and data
    parallelism takes the rest. The device is the card unless the caller
    passes ``device="cpu"``.
    """
    n = int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one slot, got {n}")
    if tp is None:
        tp = 1
        while tp * 2 <= min(n, 4) and n % (tp * 2) == 0:
            tp *= 2
    if n % tp:
        raise ValueError(f"tp={tp} must divide n={n}")
    return TrainingMesh(resolve_device(device), n // tp, int(tp))


def mesh_size(mesh: ShardMesh) -> int:
    return mesh.slots
