"""Device selection for the port.

Everything under ``Node`` runs on ``cuda`` unless the caller asks for the
CPU. A missing card is an error, never a quiet fall to the CPU.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: Optional[DeviceLike] = None) -> torch.device:
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


def resolve_devices(device: Union[None, DeviceLike, Sequence[DeviceLike]]
                    = None) -> Tuple[torch.device, ...]:
    """A node's device list, the reference's ``jax.devices()`` rule.

    ``None`` or ``"cuda"``: every visible card in ordinal order.
    ``"cuda:N"``: that card alone. ``"cpu"``: the CPU, only when asked.
    A sequence, or a comma list in one string (the launcher's
    ``--device cuda:0,cuda:1``), names each mesh device in turn, each
    resolved by the same rule, with ``cuda`` there meaning the current
    card. A list may name one device more than once: each entry is one
    mesh device with a residency of its own, which is how a machine with
    one card, or the CPU, runs the code of several (``["cpu"] * 8`` is
    the reference's eight virtual CPU devices). That is the caller's
    choice, never a fallback. A missing card raises."""
    if isinstance(device, str) and "," in device:
        device = [d.strip() for d in device.split(",") if d.strip()]
    if device is None or isinstance(device, (str, torch.device)):
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            return tuple(torch.device("cuda", i)
                         for i in range(torch.cuda.device_count()))
        return (_visible(dev),)
    out = []
    for d in device:
        dev = resolve_device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        out.append(_visible(dev))
    if not out:
        raise ValueError("a device list needs at least one device")
    return tuple(out)


def _visible(dev: torch.device) -> torch.device:
    if dev.type == "cuda" and dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"no CUDA device [{dev}]: "
                           f"{torch.cuda.device_count()} visible")
    return dev


def is_hopper(device: Optional[Union[str, torch.device]] = None) -> bool:
    """True when the card has compute capability (9, 0) (H100/H200), the
    target the kernels are built for (sm_90a)."""
    return torch.cuda.get_device_capability(resolve_device(device)) == (9, 0)
