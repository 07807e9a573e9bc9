"""Device selection for the port.

Everything under ``Node`` runs on ``cuda`` unless the caller asks for the
CPU. A missing card is an error, never a quiet fall to the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``cuda`` when asked or by default; ``cpu`` only when asked. Raises
    when ``cuda`` is wanted and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device [{dev}]: use cuda or cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return dev


def is_hopper(device: Optional[Union[str, torch.device]] = None) -> bool:
    """True when the card has compute capability (9, 0) (H100/H200), the
    target the kernels are built for (sm_90a)."""
    return torch.cuda.get_device_capability(resolve_device(device)) == (9, 0)
