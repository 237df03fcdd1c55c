"""Device/host layer placement for models larger than the card's memory.

Counterpart of ``blazr_tpu/loader/offloading.py``: a ``LayerDeviceMap``
(the first layers on the device, the rest in host RAM), the number of
layers that fit beside a 2 GiB KV reserve, parameter bytes from a VarMap's
logical shapes, and ``plan_offload``. ``device_free_memory`` reads the
card (``torch.cuda.mem_get_info``); None without one. A map with host
layers is served by ``engine/offload_stream.py::StreamingModel``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

KV_RESERVE_BYTES = 2 << 30          # headroom kept for the KV cache


class DevicePlacement:
    DEVICE = "device"
    HOST = "host"


@dataclass
class LayerDeviceMap:
    """Layer index → placement."""

    placements: list[str]

    @classmethod
    def with_device_layers(cls, total_layers: int, device_layers: int) -> "LayerDeviceMap":
        device_layers = max(0, min(device_layers, total_layers))
        return cls([DevicePlacement.DEVICE] * device_layers
                   + [DevicePlacement.HOST] * (total_layers - device_layers))

    @property
    def num_device_layers(self) -> int:
        return sum(1 for p in self.placements if p == DevicePlacement.DEVICE)

    @property
    def fully_resident(self) -> bool:
        return self.num_device_layers == len(self.placements)

    def placement(self, layer: int) -> str:
        return self.placements[layer]


def device_free_memory(device=None) -> Optional[int]:
    """Free bytes on ``device`` (default: the current CUDA device); None on
    the CPU or without a card."""
    import torch

    if not torch.cuda.is_available() or (device is not None
                                         and torch.device(device).type != "cuda"):
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return int(free)


def compute_device_layer_budget(per_layer_bytes: int, total_layers: int,
                                other_bytes: int = 0,
                                free_bytes: Optional[int] = None) -> int:
    """How many layers fit on the device beside ``other_bytes`` and the KV
    reserve; every layer when the free memory is unknown."""
    if free_bytes is None:
        free_bytes = device_free_memory()
    if free_bytes is None or per_layer_bytes <= 0:
        return total_layers
    budget = free_bytes - KV_RESERVE_BYTES - other_bytes
    return max(0, min(total_layers, budget // per_layer_bytes))


def estimate_param_bytes(vm, num_layers: int) -> tuple[int, int]:
    """(bytes a layer, bytes outside the layers) from a VarMap: a
    QuantTensor's words, scales and mins at 4 bytes each, a dense tensor at
    2 bytes an element (bf16 on the device)."""
    from ..quant.qtensor import QuantTensor

    per_layer = other = 0
    for name in vm.names():
        w = vm.get(name)
        if isinstance(w, QuantTensor):
            nbytes = (w.qweight.numel() + w.scales.numel() + w.mins.numel()) * 4
        else:
            nbytes = int(np.prod(tuple(w.shape))) * 2
        if ".layers." in name:
            per_layer += nbytes
        else:
            other += nbytes
    return per_layer // max(num_layers, 1), other


class OffloadResidencyError(RuntimeError):
    """Inference asked of a model whose layers are not all resident, where
    the path cannot stream them (the reference's hard error)."""


def plan_offload(vm, num_layers: int,
                 requested_device_layers: Optional[int] = None) -> LayerDeviceMap:
    """The placement map: the requested number of device layers, else as
    many as fit."""
    if requested_device_layers is not None:
        lm = LayerDeviceMap.with_device_layers(num_layers, requested_device_layers)
    else:
        per_layer, other = estimate_param_bytes(vm, num_layers)
        lm = LayerDeviceMap.with_device_layers(
            num_layers, compute_device_layer_budget(per_layer, num_layers, other))
    logger.info("layer placement: %d/%d on device", lm.num_device_layers, num_layers)
    return lm
