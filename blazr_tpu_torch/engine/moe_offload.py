"""MoE expert offload: a hot expert set on the card, the rest in host RAM.

Counterpart of ``blazr_tpu/engine/moe_offload.py``: ``OffloadStrategy`` and
``resolve_strategy`` (:25-46), ``ExpertFrequencyTracker`` (:49-74),
``ExpertPlacement`` and ``MoeOffloadManager`` (:77-134), ``OffloadRuntime``
(:187-258) and ``install_offload`` (:268-330).

Each MoE layer's params hold a RESIDENT expert stack ``[K, ...]`` and
``resident_ids`` (slot → expert id); ``models/moe.py::moe_ffn_offload`` runs
the resident experts through B1 and adds the cold experts' term
Σ cold_w·expert_e(x), computed on the host in f32 from this runtime's host
mirror, as the JAX package does. How the port differs:

  * usage counts stay on the device: each MoE call adds its routed ids to
    an ``[L, E]`` f64 buffer (one ``index_add_``) and each ``tick`` decays
    it in place (the JAX tracker's arithmetic, its counts exactly); the
    host reads the buffer once per rebalance, not once per layer;
  * a rebalance writes the incoming experts into their resident slots in
    place (``copy_`` from the pinned host mirror) and ``resident_ids`` in
    place too, so tensors a step holds stay valid;
  * the host term dequantizes only the cold experts a call reaches
    (``qtensor.dequantize_stack_np`` on one expert) and keeps the f32
    copies of the first that fit under ``COLD_CACHE_MAX_BYTES``, scratch
    included, for the process's life; the rest are dequantized again at
    each use into one scratch set. The JAX ``dense_experts`` (:204-219)
    caches every expert of a layer in f32: 5.6 GB a layer at Mixtral-8x7B's
    widths, ~180 GB for 32 layers (ROADMAP §C, faults known in the
    reference);
  * the free device memory that AUTO resolves against is
    ``torch.cuda.mem_get_info``'s.

An offloaded model's forward reads the host once a MoE layer, so its steps
cannot be CUDA graphs: both engines run them eagerly (ROADMAP §C).
"""

from __future__ import annotations

import dataclasses
import enum
import logging
import threading
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..loader.offloading import device_free_memory
from ..quant.qtensor import QuantTensor, dequantize_stack_np

logger = logging.getLogger(__name__)

_EXPERT_KEYS = ("experts_gate", "experts_up", "experts_down")

# The most bytes of dequantized f32 experts the host term holds, its scratch
# included: 8 GiB keeps 11 of Mixtral-8x7B's 704 MB experts beside the
# scratch for a 12th.
COLD_CACHE_MAX_BYTES = 8 << 30


class OffloadStrategy(enum.Enum):
    AUTO = "auto"
    DEVICE = "gpu"        # the reference's name: every expert on the card
    HOST = "cpu"          # one expert a layer on the card, the rest on the host
    HYBRID = "hybrid"     # the hot half on the card, the cold half on the host


def resolve_strategy(strategy: OffloadStrategy, expert_bytes_total: int,
                     device_free_bytes: Optional[int],
                     reserve_bytes: int = 2 << 30) -> OffloadStrategy:
    """AUTO → a concrete strategy against the free device memory."""
    if strategy != OffloadStrategy.AUTO:
        return strategy
    if device_free_bytes is None:
        return OffloadStrategy.DEVICE
    budget = device_free_bytes - reserve_bytes
    if expert_bytes_total <= budget:
        return OffloadStrategy.DEVICE
    if expert_bytes_total // 2 <= budget:
        return OffloadStrategy.HYBRID
    return OffloadStrategy.HOST


class ExpertFrequencyTracker:
    """Exponentially decayed usage counts per (layer, expert), held on
    ``device`` as f64 [L, E]: ``record`` adds 1 per routed id, ``step``
    multiplies by ``decay``, as the JAX tracker does on the host."""

    def __init__(self, num_layers: int, num_experts: int, decay: float = 0.95,
                 device: torch.device = torch.device("cpu")):
        self.counts = torch.zeros((num_layers, num_experts), dtype=torch.float64,
                                  device=device)
        self.decay = decay
        self.steps = 0

    def record(self, layer: int, expert_ids) -> None:
        ids = torch.as_tensor(expert_ids, device=self.counts.device).reshape(-1).long()
        self.counts[layer].index_add_(0, ids, torch.ones(ids.shape, dtype=torch.float64,
                                                         device=ids.device))

    def step(self) -> None:
        """One forward pass completed: decay the window."""
        self.steps += 1
        self.counts.mul_(self.decay)

    def hot_set(self, layer: int, k: int, counts: Optional[np.ndarray] = None) -> list[int]:
        """The layer's top-K experts (ties to the lower id); ``counts`` is a
        host copy of every layer's counts, read here when not given."""
        row = (self.counts[layer].cpu().numpy() if counts is None else counts[layer])
        return [int(i) for i in np.argsort(-row, kind="stable")[:k]]


@dataclass
class ExpertPlacement:
    """Which experts are device-resident per layer."""

    on_device: list[set[int]]


class MoeOffloadManager:
    """Tracks usage and rebalances the device-resident expert set. It owns
    the slot lists (``resident[layer]``: slot → expert id); the placement
    sets are read from them, and a rebalance puts each incoming expert in
    an outgoing one's slot."""

    def __init__(self, num_layers: int, num_experts: int, device_experts_per_layer: int,
                 rebalance_interval: int = 64,
                 strategy: OffloadStrategy = OffloadStrategy.HYBRID,
                 device: torch.device = torch.device("cpu")):
        self.num_layers = num_layers
        self.num_experts = num_experts
        self.k = min(device_experts_per_layer, num_experts)
        self.rebalance_interval = rebalance_interval
        self.strategy = strategy
        self.tracker = ExpertFrequencyTracker(num_layers, num_experts, device=device)
        self.resident = [list(range(self.k)) for _ in range(num_layers)]
        self.transfers = 0
        self.rebalances = 0
        self._since_rebalance = 0

    @property
    def placement(self) -> ExpertPlacement:
        return ExpertPlacement(on_device=[set(r) for r in self.resident])

    def record_usage(self, layer: int, expert_ids) -> None:
        self.tracker.record(layer, expert_ids)

    def step(self) -> Optional[list[tuple[int, list[int], list[int]]]]:
        """Advance one forward pass; every ``rebalance_interval`` passes the
        transfer plan [(layer, to_device, to_host), ...]."""
        self.tracker.step()
        self._since_rebalance += 1
        if self.strategy != OffloadStrategy.HYBRID:
            return None
        if self._since_rebalance < self.rebalance_interval:
            return None
        self._since_rebalance = 0
        return self.rebalance()

    def rebalance(self) -> list[tuple[int, list[int], list[int]]]:
        counts = self.tracker.counts.cpu().numpy()      # one read for every layer
        plan = []
        for layer, res in enumerate(self.resident):
            want = set(self.tracker.hot_set(layer, self.k, counts))
            have = set(res)
            to_device, to_host = sorted(want - have), sorted(have - want)
            if to_device or to_host:
                plan.append((layer, to_device, to_host))
                for out_e, in_e in zip(to_host, to_device):
                    res[res.index(out_e)] = in_e
                self.transfers += len(to_device) + len(to_host)
        self.rebalances += 1
        if plan:
            logger.info("MoE rebalance: %d layers changed, %d total transfers",
                        len(plan), self.transfers)
        return plan


class ColdExpertCache:
    """Dequantized f32 experts (gate, up, down) on the host, keyed (layer,
    expert). The first experts that fit are kept for the process's life
    and nothing is evicted: the forward visits its layers in a cycle, so
    once they pass the cap an LRU cache would evict each expert before its
    next use and never hit. Each later miss is dequantized into one
    scratch set, reused. ``max_bytes`` bounds the kept bytes and the
    scratch together once it holds one expert; below that an expert is
    dequantized into the scratch and nothing is kept."""

    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        self._entries: dict = {}
        self._scratch: dict = {}          # shapes → a tuple of f32 tensors
        self.bytes = 0                    # kept
        self.peak_bytes = 0               # kept and scratch
        self.hits = 0
        self.misses = 0

    def get(self, key: tuple[int, int], shapes: tuple, make):
        """The entry of ``key``; on a miss ``make(out)`` dequantizes it,
        into new tensors (``out`` None) when they fit beside room for one
        scratch set, else into the scratch set of ``shapes``."""
        hit = self._entries.get(key)
        if hit is not None:
            self.hits += 1
            return hit
        self.misses += 1
        nbytes = sum(4 * int(np.prod(s)) for s in shapes)
        if self.bytes + 2 * nbytes <= self.max_bytes:
            value = make(None)
            self._entries[key] = value
            self.bytes += nbytes
        else:
            out = self._scratch.get(shapes)
            if out is None:
                out = self._scratch[shapes] = tuple(torch.empty(s) for s in shapes)
            value = make(out)
        scratch = sum(4 * int(np.prod(s)) for sh in self._scratch for s in sh)
        self.peak_bytes = max(self.peak_bytes, self.bytes + scratch)
        return value

    def clear(self) -> None:
        self._entries.clear()
        self._scratch.clear()
        self.bytes = 0


def _planes(w) -> tuple[torch.Tensor, ...]:
    return (w.qweight, w.scales, w.mins) if isinstance(w, QuantTensor) else (w,)


def _map_planes(w, fn):
    """``w`` (a stacked QuantTensor or a dense stack) with ``fn`` applied to
    each of its planes."""
    if isinstance(w, QuantTensor):
        return dataclasses.replace(w, qweight=fn(w.qweight), scales=fn(w.scales),
                                   mins=fn(w.mins), perm=None)
    return fn(w)


class OffloadRuntime:
    """The host side of MoE expert offload for one loaded model."""

    def __init__(self, manager: MoeOffloadManager, device: torch.device):
        self.manager = manager
        self.device = device
        self.host: dict[int, dict[str, Any]] = {}      # layer → key → host stack
        self.params: dict[int, dict[str, Any]] = {}    # layer → its MoE params
        self.cold_cache = ColdExpertCache(COLD_CACHE_MAX_BYTES)
        # One engine's forward at a time computes a host term (its scratch).
        self._lock = threading.Lock()
        self.cold_accesses = 0       # host-term calls that had a cold expert
        self.cold_experts = 0        # expert terms computed on the host
        self.moved = 0               # experts written into resident slots

    @property
    def resident(self) -> dict[int, list[int]]:
        """MoE layer → slot → expert id: the manager's slot lists."""
        return {i: self.manager.resident[i] for i in self.params}

    def close(self) -> None:
        self.cold_cache.clear()
        self.host.clear()

    # -- the forward's calls ----------------------------------------------
    def record(self, layer: int, topk_idx: torch.Tensor) -> None:
        self.manager.record_usage(layer, topk_idx)

    def dense_expert(self, layer: int, e: int) -> tuple[torch.Tensor, ...]:
        """Expert ``e`` of ``layer`` as f32 host tensors (gate [H, I], up
        [H, I], down [I, H]), through the bounded cache."""
        stacks = [self.host[layer][key] for key in _EXPERT_KEYS]
        shapes = tuple((w.in_features, w.out_features) if isinstance(w, QuantTensor)
                       else tuple(w.shape[1:]) for w in stacks)

        def make(out):
            res = []
            for i, w in enumerate(stacks):
                dst = None if out is None else out[i]
                if isinstance(w, QuantTensor):
                    res.append(torch.from_numpy(dequantize_stack_np(
                        w, experts=[e], out=None if dst is None else dst[None])[0]))
                elif dst is None:
                    res.append(w[e].to(torch.float32))
                else:
                    res.append(dst.copy_(w[e]))
            return tuple(res)

        return self.cold_cache.get((layer, e), shapes, make)

    def cold_term(self, layer: int, flat: torch.Tensor,
                  cold_w: torch.Tensor) -> Optional[torch.Tensor]:
        """Σ_e cold_w[:, e]·expert_e(flat) over the experts with a nonzero
        weight, in f32 on the host, in ascending e: [N, H] f32 on
        ``flat``'s device; None when no row routes to a cold expert."""
        w = cold_w.to(torch.float32).cpu()
        experts = torch.nonzero(w.ne(0).any(dim=0)).flatten().tolist()
        if not experts:
            return None
        x = flat.to(torch.float32).cpu()
        out = torch.zeros_like(x)
        with self._lock:
            for e in experts:
                rows = torch.nonzero(w[:, e]).flatten()
                gate, up, down = self.dense_expert(layer, e)
                xe = x[rows]
                a = F.silu(xe @ gate) * (xe @ up)
                out[rows] += w[rows, e][:, None] * (a @ down)
                self.cold_experts += 1
            self.cold_accesses += 1
        return out.to(flat.device)

    # -- the engines' call, once a forward pass -----------------------------
    def tick(self) -> int:
        """Advance one forward pass; carry out a rebalance plan by writing
        the incoming experts into the outgoing ones' slots in place.
        Returns the experts moved."""
        plan = self.manager.step()
        if not plan:
            return 0
        moved = 0
        for layer, to_device, _ in plan:
            p = self.params[layer]
            res = self.manager.resident[layer]
            pairs = [(slot, e) for slot, e in enumerate(res) if e in to_device]
            for key in _EXPERT_KEYS:
                for dst, src in zip(_planes(p[key]), _planes(self.host[layer][key])):
                    for slot, e in pairs:
                        dst[slot].copy_(src[e], non_blocking=True)
            p["resident_ids"].copy_(torch.tensor(res, dtype=p["resident_ids"].dtype))
            moved += len(pairs)
        self.moved += moved
        return moved


def install_offload(params: dict[str, Any], model_cfg, inference_cfg,
                    device: torch.device) -> tuple[dict[str, Any], Optional[OffloadRuntime]]:
    """Put the MoE layers of ``params`` (in place) under
    ``inference.moe_offload`` (auto|gpu|cpu|hybrid): the cold experts to a
    host mirror, the first K to the card. (params, runtime); runtime None
    when every expert stays on the card."""
    moe_cfg = getattr(model_cfg, "moe", None)
    layers = params.get("layers") or []
    moe_layers = [i for i, lp in enumerate(layers)
                  if isinstance(lp, dict) and lp.get("moe") is not None]
    if moe_cfg is None or not moe_layers:
        return params, None
    expert_bytes = sum(t.numel() * t.element_size() for i in moe_layers
                       for key in _EXPERT_KEYS for t in _planes(layers[i]["moe"][key]))
    strategy = resolve_strategy(OffloadStrategy(inference_cfg.moe_offload), expert_bytes,
                                device_free_memory(device))
    if strategy == OffloadStrategy.DEVICE:
        return params, None
    e = moe_cfg.num_experts
    k_res = inference_cfg.moe_device_experts or inference_cfg.moe_gpu_experts
    if k_res is None:
        k_res = 1 if strategy == OffloadStrategy.HOST else max(1, e // 2)
    k_res = max(1, min(int(k_res), e))
    if k_res >= e:
        return params, None
    manager = MoeOffloadManager(len(layers), e, k_res,
                                rebalance_interval=inference_cfg.moe_rebalance_interval,
                                strategy=OffloadStrategy.HYBRID, device=device)
    rt = OffloadRuntime(manager, device)
    resident0 = list(range(k_res))
    idx = torch.tensor(resident0)

    def host(t: torch.Tensor) -> torch.Tensor:       # pinned for async copies
        t = t.detach().to("cpu")
        return t.pin_memory() if device.type == "cuda" else t

    for i in moe_layers:
        p = layers[i]["moe"]
        rt.host[i] = {}
        for key in _EXPERT_KEYS:
            rt.host[i][key] = _map_planes(p[key], host)
            p[key] = None                       # the full device stack goes
            p[key] = _map_planes(rt.host[i][key], lambda t: t[idx].to(device))
        rt.params[i] = p
        p["resident_ids"] = torch.tensor(resident0, dtype=torch.long, device=device)
        p["offload_rt"] = rt
        p["offload_layer"] = i
    logger.info("MoE offload active (%s): %d/%d experts device-resident per layer, "
                "%d MoE layers, %.2f GB expert weights", strategy.value, k_res, e,
                len(moe_layers), expert_bytes / 1e9)
    return params, rt


def ensure_offload(model, inference_cfg) -> Optional[OffloadRuntime]:
    """The model's offload runtime: installed once per model under
    ``inference.moe_offload`` (the Executor and a BatchEngine over the same
    model share it, as the JAX engines share ``model.moe_offload_rt``)."""
    rt = getattr(model, "moe_offload_rt", None)
    if rt is None and inference_cfg.moe_offload:
        _, rt = install_offload(model.params, model.cfg, inference_cfg, model.device)
        model.moe_offload_rt = rt
    return rt
