"""Expert parallelism: capacity dispatch, each rank's experts on its kept
rows.

Counterpart of ``blazr_tpu/parallel/ep.py`` (:44-135). The JAX package
builds a one-hot [T, E, C] dispatch, runs every expert over its C slots in
f32 einsums on dequantized stacks, and lets GSPMD lower the expert axis'
resharding to all-to-alls. The port keeps the function and changes the
route:

  * ``dispatch_slots`` gives each (token, choice) its slot in its expert's
    queue in order of arrival (the cumsum over tokens of ``make_dispatch``)
    and drops what lies past ``capacity``; ``make_dispatch`` builds the JAX
    package's (dispatch, combine, dropped) from it;
  * ``moe_ffn_ep``: every rank routes every token (the router is whole), then
    runs its E/ep experts (``parallel/tp.py::MoeShard``) over their kept rows
    only (``models/moe.py::_routed_expert_sum`` on the rank's local ids,
    through ``layers.linear``: kernel B1 for quantized stacks, their
    tensor-parallel slices too), adds each row's weighted term in f32, and
    the ranks' sums are added over the ep×tp group: the function the
    all-to-alls compute, with one all-reduce. The shared experts are whole
    on every rank and added after.

``DROPPED_TOKENS`` counts capacity drops when ``MoeConfig.ep_count_drops``
is on (a host read a layer); ``/metrics`` reports it as
``moe_tokens_dropped``.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch

from ..config.model_config import MoeConfig
from ..models.moe import _routed_expert_sum, _scatter_weights, _shared_expert_add, route
from .comm import all_reduce

# Capacity drops since start (read by /metrics), counted only under
# MoeConfig.ep_count_drops, as in the JAX package.
DROPPED_TOKENS = {"count": 0}


def default_capacity(tokens: int, moe: MoeConfig, capacity_factor: float = 1.25) -> int:
    """Slots an expert: ceil(T·k/E · factor), rounded up to a multiple of 8
    (JAX :89-93)."""
    capacity = max(1, int(math.ceil(
        (tokens * moe.experts_per_tok / moe.num_experts) * capacity_factor)))
    return (capacity + 7) // 8 * 8


def dispatch_slots(topk_idx: torch.Tensor, num_experts: int,
                   capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(slot [T, K], keep [T, K]): each (token, choice) pair's place in its
    expert's queue, in order of arrival over the flattened (token, choice)
    axis, and whether it lies within ``capacity``."""
    t, k = topk_idx.shape
    onehot = torch.nn.functional.one_hot(topk_idx.to(torch.long), num_experts)   # [T,K,E]
    flat = onehot.reshape(t * k, num_experts)
    pos_in_expert = torch.cumsum(flat, dim=0) - flat
    slot = (pos_in_expert * flat).sum(dim=1).reshape(t, k)
    return slot, slot < capacity


def make_dispatch(topk_idx: torch.Tensor, topk_w: torch.Tensor, num_experts: int,
                  capacity: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The JAX package's (dispatch [T, E, C] f32 one-hot, combine [T, E, C]
    f32, dropped scalar int32): the reference form of ``dispatch_slots``."""
    slot, keep = dispatch_slots(topk_idx, num_experts, capacity)
    slot = torch.where(keep, slot, torch.zeros_like(slot))
    onehot = torch.nn.functional.one_hot(topk_idx.to(torch.long), num_experts).float()
    slot_oh = torch.nn.functional.one_hot(slot, capacity).float()            # [T,K,C]
    disp = (onehot[..., None] * slot_oh[:, :, None, :]
            * keep.float()[:, :, None, None])                                # [T,K,E,C]
    combine = torch.einsum("tkec,tk->tec", disp, topk_w.float())
    return disp.sum(dim=1), combine, (~keep).sum().to(torch.int32)


def moe_ffn_ep(x: torch.Tensor, p: dict[str, Any], moe: MoeConfig,
               capacity_factor: float = 1.25,
               capacity: Optional[int] = None) -> torch.Tensor:
    """The expert-parallel MoE FFN over x [B, T, H] (JAX :73-119): tokens
    past an expert's capacity are dropped, as in the JAX package. A layer
    without ``p["mesh"]`` holds every expert (one rank)."""
    b, t, h = x.shape
    flat = x.reshape(b * t, h)
    topk_idx, topk_w = route(flat, p["router"], moe, p.get("correction_bias"))
    e = moe.num_experts
    if capacity is None:
        capacity = default_capacity(b * t, moe, capacity_factor)
    _, keep = dispatch_slots(topk_idx, e, capacity)
    if moe.ep_count_drops:
        DROPPED_TOKENS["count"] += int((~keep).sum())
    shard = p.get("mesh")
    first, count = (shard.first, shard.count) if shard is not None else (0, e)
    # This rank's kept pairs as local expert ids; the rest are -1 (skipped).
    mine = keep & (topk_idx >= first) & (topk_idx < first + count)
    local = torch.where(mine, topk_idx - first, torch.full_like(topk_idx, -1))
    weights = _scatter_weights(topk_idx, topk_w, e)[:, first:first + count]
    acc = _routed_expert_sum(flat, p["experts_gate"], p["experts_up"], p["experts_down"],
                             local, weights)
    if shard is not None:
        acc = all_reduce(acc, shard.axis)
    out = _shared_expert_add(acc, flat, p)
    return out.reshape(b, t, h).to(x.dtype)
