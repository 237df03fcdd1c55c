"""Device resolution for the port's entry points.

Every entry point runs on ``cuda`` unless its caller names another device.
There is no quiet fallback to the CPU: asking for CUDA on a machine
without a card raises.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; raise if the resolved device is CUDA and no
    card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "blazr_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain versions on the CPU")
    return dev


def check_on(device: torch.device, *tensors: Optional[torch.Tensor]) -> None:
    """Raise unless every given tensor lies on ``device`` (type and index)."""
    for t in tensors:
        if t is None:
            continue
        if t.device.type != device.type or (
                device.index is not None and t.device.index != device.index):
            raise ValueError(f"tensor on {t.device}, expected {device}")
