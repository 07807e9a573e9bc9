"""The shard mesh over the node's devices, and the training mesh.

Port of elasticsearch_tpu/parallel/mesh.py's ``shard_mesh``,
``training_mesh`` and ``mesh_size``. The reference lays shards over a
``('shard',)`` mesh of ``min(n_shards, len(devices))`` devices and
merges with collectives. Here a ``ShardMesh`` holds S slots (one per
shard) over the same number of mesh devices: slot ``s`` lives on mesh
device ``s % n_devices``, the reference's slot rule. On each device a
slot's data is its segment's own tensors (or a row of a slot-stacked
``[S_d, ...]`` tensor); ``all_gather`` is each device's ``[S_d, k]``
result copied to the first device, ``psum`` an int64 sum there
(``parallel/executor.py``). A device list may name one device more than
once (``utils/device.py::resolve_devices``): each entry is a mesh
device of its own.

The models' meshes are slots of one device. ``training_mesh`` keeps
the reference's ``('dp', 'tp')`` factorisation, which decides the batch
divisibility and the tensor-parallel specs of
``models/dual_encoder.py::param_shardings``; the train step itself runs
whole on the device, so there is no all-reduce to insert and a step
under any factorisation is the same computation. The ring encoder's
``('sp',)`` axis is a ``ShardMesh`` of sequence slots on one device
(``models/ring_encoder.py::build_sp_mesh``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from elasticsearch_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class ShardMesh:
    """S slots (shards, or a sequence's blocks) over ``devices``: slot
    ``s`` on ``devices[s % len(devices)]``."""

    devices: Tuple[torch.device, ...]
    slots: int

    @property
    def device(self) -> torch.device:
        """The first mesh device: where the devices' results merge."""
        return self.devices[0]

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    def device_of(self, slot: int) -> int:
        """The mesh device (its index in ``devices``) of ``slot``."""
        return slot % len(self.devices)

    def slots_of(self, d: int) -> List[int]:
        """The slots on mesh device ``d``, in order."""
        return list(range(d, self.slots, len(self.devices)))


def shard_mesh(n_shards: int,
               devices: Union[torch.device, str,
                              Sequence[Union[torch.device, str]]]
               ) -> ShardMesh:
    """One slot per shard over ``min(n_shards, len(devices))`` of
    ``devices`` (one device or a sequence), the reference's count."""
    if n_shards < 1:
        raise ValueError(f"a mesh needs at least one slot, got {n_shards}")
    if isinstance(devices, (str, torch.device)):
        devices = [devices]
    devs = tuple(torch.device(d) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return ShardMesh(devs[:min(int(n_shards), len(devs))], int(n_shards))


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
