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

The models' meshes follow the same device rule. ``training_mesh(n)``
keeps the reference's ``('dp', 'tp')`` factorisation of n positions
and lays position ``p`` (dp-major: ``p = dp_rank * tp + tp_rank``, the
reference's ``reshape(n // tp, tp)``) on device ``p % m`` of the first
``m = min(n, len(devices))`` devices; ``models/dual_encoder.py``'s mesh
step keeps each position's parameter shard on its device. The ring
encoder's ``('sp',)`` axis is a ``ShardMesh`` of sequence slots
(``models/ring_encoder.py::build_sp_mesh``) and the postings split's
term ranges lie over the node's registries the same way
(``parallel/postings_shard.py``). The reference's meshes shrink to the
devices there are; the port keeps its count of positions and wraps
them, so ``training_mesh(8, device="cpu")`` runs the sharded step with
every position on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from elasticsearch_tpu_torch.utils.device import resolve_devices


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
    """The reference's 2-D ``('dp', 'tp')`` mesh: ``grid[g][r]`` is the
    device of data-parallel group g's tensor-parallel rank r."""

    grid: Tuple[Tuple[torch.device, ...], ...]

    @property
    def dp(self) -> int:
        return len(self.grid)

    @property
    def tp(self) -> int:
        return len(self.grid[0])

    @property
    def device(self) -> torch.device:
        """The first position's device: where the groups' embeddings
        meet for the loss and the gradients are summed."""
        return self.grid[0][0]

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        """Every position's device, dp-major."""
        return tuple(d for row in self.grid for d in row)

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "tp": self.tp}

    def device_of(self, dp_rank: int, tp_rank: int) -> torch.device:
        return self.grid[dp_rank][tp_rank]


def training_mesh(n_devices: int = 1, device=None,
                  tp: Optional[int] = None) -> TrainingMesh:
    """n positions as ``(n // tp, tp)`` over the devices of ``device``
    (``utils/device.py::resolve_devices``: every visible card by default,
    ``"cpu"`` only when asked, a list that may name one device several
    times): position p on device ``p % min(n, len(devices))``.

    tp defaults to the largest power of two <= min(n, 4) that divides n,
    the reference's rule: tensor-parallel groups stay small and data
    parallelism takes the rest.
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
    devs = resolve_devices(device)
    m = min(n, len(devs))
    tp = int(tp)
    return TrainingMesh(tuple(
        tuple(devs[(g * tp + r) % m] for r in range(tp))
        for g in range(n // tp)))


def mesh_size(mesh: ShardMesh) -> int:
    return mesh.slots
