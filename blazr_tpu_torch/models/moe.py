"""Mixture-of-experts FFN: routing, expert compute and shared experts.

Counterpart of ``blazr_tpu/models/moe.py``: ``route`` (:30),
``_expert_mlp_all``, ``_weighted_expert_sum`` (:81), ``_scatter_weights``,
``_shared_expert_add``, ``moe_ffn`` (:124), ``moe_forward`` (:195) and
``build_moe_params`` (:208), for Mixtral, Qwen2-MoE and Qwen3-MoE on the
llama forwards (softmax top-k), with DeepSeek's sigmoid scoring, correction
bias and group-limited routing in ``route``.

Dense expert stacks take the JAX package's einsum over every expert.
Quantized stacks (``qtensor.stack_quant``) run each expert projection
through ``layers.linear`` (kernel B1 on the card) and sum
``weights[:, e] · down_e(silu(gate_e x) · up_e x)`` in f32 over the experts
in ascending order. Which rows an expert takes follows the call's shape,
unless the caller asks for every expert (``every_expert``):

  * decode (T = 1, the shape of every captured decode step, and the
    speculative verify step at T = k+1, which asks for it): every expert
    over every row, the JAX scan; an unchosen expert weighs 0. Fixed shapes
    and no host read, so the step stays one CUDA graph;
  * prefill (T > 1, eager): each expert over the rows routed to it, added
    back in ascending expert order. It leaves out exactly the terms the
    decode form weighs by 0, so it computes the same function, at the cost
    of one host read of the per-expert counts a layer.

Qwen2-MoE's shared expert, scaled by ``sigmoid(shared_expert_gate(x))``,
follows transformers' ``Qwen2MoeSparseMoeBlock``; the JAX package drops it
(ROADMAP §C). An offloaded layer (``engine/moe_offload.py``) takes
``moe_ffn_offload`` (JAX :150): its resident experts as above, its cold
experts' term on the host. Under a mesh a layer holds its rank's slice
(``parallel/tp.py``): tensor-parallel slices reduce the routed sum over the
ranks before the shared expert is added, and an ep axis takes
``parallel/ep.py::moe_ffn_ep`` (capacity dispatch, each rank's experts on
their kept rows through B1).
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from ..config.model_config import MoeConfig, UniversalConfig
from ..parallel.comm import all_reduce
from ..quant.qtensor import QuantTensor, expert_slice, stack_quant
from .layers import linear


def route(x: torch.Tensor, router_w: torch.Tensor, moe: MoeConfig,
          correction_bias: Optional[torch.Tensor] = None
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(topk_idx [N, k] int64, topk_weights [N, k] f32) of x [N, H] through
    the router [H, E], scored in f32."""
    logits = x.to(torch.float32) @ router_w.to(torch.float32)
    e = logits.shape[-1]
    if moe.scoring_func == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    choice = scores
    if correction_bias is not None:
        choice = scores + correction_bias.to(torch.float32)[None, :]
    if moe.n_group > 1:
        # Group-limited routing (DeepSeek-V3): keep the topk_group groups
        # with the largest top-2 sums, push the others to -1e9.
        n = choice.shape[0]
        per_group = e // moe.n_group
        grouped = choice.reshape(n, moe.n_group, per_group)
        top2 = grouped.topk(min(2, per_group), dim=-1).values.sum(dim=-1)
        group_idx = top2.topk(moe.topk_group, dim=-1).indices
        group_mask = torch.zeros((n, moe.n_group), dtype=torch.float32,
                                 device=x.device).scatter_(1, group_idx, 1.0)
        keep = group_mask.repeat_interleave(per_group, dim=1) > 0
        choice = ((grouped * group_mask[:, :, None]).reshape(n, e)
                  + torch.where(keep, 0.0, -1e9))
    topk_idx = choice.topk(moe.experts_per_tok, dim=-1).indices
    topk_w = scores.gather(-1, topk_idx)
    if moe.norm_topk_prob:
        topk_w = topk_w / (topk_w.sum(dim=-1, keepdim=True) + 1e-20)
    return topk_idx, topk_w * moe.routed_scaling_factor


def _scatter_weights(topk_idx: torch.Tensor, topk_w: torch.Tensor,
                     num_experts: int) -> torch.Tensor:
    """[N, k] top-k routing → dense [N, E] f32 weights."""
    return torch.zeros((topk_idx.shape[0], num_experts), dtype=torch.float32,
                       device=topk_idx.device).scatter_add_(1, topk_idx,
                                                            topk_w.to(torch.float32))


def _expert_mlp_all(x: torch.Tensor, gate_w: torch.Tensor, up_w: torch.Tensor,
                    down_w: torch.Tensor) -> torch.Tensor:
    """x [N, H] through every expert of dense stacks [E, H, I] / [E, I, H]
    → [N, E, H]."""
    g = torch.einsum("nh,ehi->nei", x, gate_w.to(x.dtype))
    u = torch.einsum("nh,ehi->nei", x, up_w.to(x.dtype))
    return torch.einsum("nei,eih->neh", F.silu(g) * u, down_w.to(x.dtype))


def _expert_mlp(x: torch.Tensor, gate: Any, up: Any, down: Any) -> torch.Tensor:
    """One SwiGLU expert: down(silu(gate x) · up x)."""
    return linear(F.silu(linear(x, gate)) * linear(x, up), down)


def _weighted_expert_sum(flat: torch.Tensor, gate: QuantTensor, up: QuantTensor,
                         down: QuantTensor, weights: torch.Tensor) -> torch.Tensor:
    """Decode form: ``Σ_e weights[:, e] · expert_e(flat)`` with every expert
    over every row, in ascending e. [N, H] f32."""
    acc = torch.zeros(flat.shape, dtype=torch.float32, device=flat.device)
    for e in range(weights.shape[1]):
        o = _expert_mlp(flat, expert_slice(gate, e), expert_slice(up, e),
                        expert_slice(down, e))
        acc = acc + o.to(torch.float32) * weights[:, e, None]
    return acc


def _routed_expert_sum(flat: torch.Tensor, gate: QuantTensor, up: QuantTensor,
                       down: QuantTensor, topk_idx: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """Prefill form of ``_weighted_expert_sum``: expert e runs over the rows
    that chose it (ascending), each row's term added back in ascending e. A
    row chooses an expert at most once, so each add is one term a row; an id
    of -1 is no expert of the stack. Reads the per-expert row counts to the
    host once."""
    k = topk_idx.shape[1]
    flat_idx = topk_idx.reshape(-1)
    rows_by_expert = torch.argsort(flat_idx, stable=True) // k
    # Ids of -1 (an offloaded layer's cold experts) sort first and are skipped.
    counts = torch.bincount(flat_idx + 1, minlength=weights.shape[1] + 1).tolist()
    acc = torch.zeros(flat.shape, dtype=torch.float32, device=flat.device)
    start = counts.pop(0)
    for e, c in enumerate(counts):
        if c:
            rows = rows_by_expert[start:start + c]
            o = _expert_mlp(flat.index_select(0, rows), expert_slice(gate, e),
                            expert_slice(up, e), expert_slice(down, e))
            acc.index_add_(0, rows, o.to(torch.float32)
                           * weights[:, e].index_select(0, rows)[:, None])
        start += c
    return acc


def _shared_expert_add(out: torch.Tensor, flat: torch.Tensor,
                       p: dict[str, Any]) -> torch.Tensor:
    """Add the shared expert: DeepSeek's ``shared_experts`` as they are,
    Qwen2-MoE's ``shared_expert`` scaled by sigmoid(shared_expert_gate x)."""
    if p.get("shared_gate") is None:
        return out
    s = _expert_mlp(flat, p["shared_gate"], p["shared_up"],
                    p["shared_down"]).to(torch.float32)
    if p.get("shared_expert_gate") is not None:
        s = torch.sigmoid(linear(flat, p["shared_expert_gate"]).to(torch.float32)) * s
    return out + s


def moe_ffn(x: torch.Tensor, p: dict[str, Any], moe: MoeConfig,
            every_expert: bool = False) -> torch.Tensor:
    """The MoE FFN over x [B, T, H]: router, experts, shared expert.
    ``every_expert`` takes the decode form at any T (a captured step)."""
    b, t, h = x.shape
    flat = x.reshape(b * t, h)
    topk_idx, topk_w = route(flat, p["router"], moe, p.get("correction_bias"))
    weights = _scatter_weights(topk_idx, topk_w, moe.num_experts)
    gate, up, down = p["experts_gate"], p["experts_up"], p["experts_down"]
    if not isinstance(gate, QuantTensor):
        all_out = _expert_mlp_all(flat, gate, up, down)              # [N, E, H]
        out = torch.einsum("neh,ne->nh", all_out.to(torch.float32), weights)
    elif t == 1 or every_expert:
        out = _weighted_expert_sum(flat, gate, up, down, weights)
    else:
        out = _routed_expert_sum(flat, gate, up, down, topk_idx, weights)
    if p.get("mesh") is not None:
        # Tensor-parallel expert slices: each rank's routed sum is a partial
        # of the layer's; the shared expert is whole on every rank.
        out = all_reduce(out, p["mesh"].axis)
    out = _shared_expert_add(out, flat, p)
    return out.reshape(b, t, h).to(x.dtype)


def moe_ffn_offload(x: torch.Tensor, p: dict[str, Any], moe: MoeConfig,
                    every_expert: bool = False) -> torch.Tensor:
    """The MoE FFN of an offloaded layer (JAX :150-192): the card holds the
    resident stack (``p["resident_ids"]``: slot → expert), which runs as
    ``moe_ffn``'s quantized forms do (B1), in slot order; the cold experts'
    term is computed on the host in f32 by the layer's offload runtime
    (``engine/moe_offload.py``), which also counts the routed ids."""
    b, t, h = x.shape
    flat = x.reshape(b * t, h)
    topk_idx, topk_w = route(flat, p["router"], moe, p.get("correction_bias"))
    weights = _scatter_weights(topk_idx, topk_w, moe.num_experts)
    rt, layer = p["offload_rt"], p["offload_layer"]
    rt.record(layer, topk_idx)
    res_ids = p["resident_ids"]
    res_w = weights.index_select(1, res_ids)                           # [N, K]
    gate, up, down = p["experts_gate"], p["experts_up"], p["experts_down"]
    if t == 1 or every_expert:
        out = _weighted_expert_sum(flat, gate, up, down, res_w)
    else:
        slot_of = torch.full((moe.num_experts,), -1, dtype=torch.long, device=flat.device)
        slot_of[res_ids] = torch.arange(res_ids.numel(), device=flat.device)
        out = _routed_expert_sum(flat, gate, up, down, slot_of[topk_idx], res_w)
    cold_w = weights.index_fill(1, res_ids, 0.0)
    cold = rt.cold_term(layer, flat, cold_w)
    if cold is not None:
        out = out + cold
    out = _shared_expert_add(out, flat, p)
    return out.reshape(b, t, h).to(x.dtype)


def moe_forward(x: torch.Tensor, p: dict[str, Any], moe: MoeConfig,
                every_expert: bool = False) -> torch.Tensor:
    """The serving path's MoE call (JAX :195-205): an offloaded layer's
    form, the expert-parallel one under an ep axis
    (``parallel/ep.py::moe_ffn_ep``), else ``moe_ffn``."""
    if p.get("resident_ids") is not None:
        return moe_ffn_offload(x, p, moe, every_expert)
    if moe.use_ep:
        from ..parallel.ep import moe_ffn_ep

        return moe_ffn_ep(x, p, moe)
    return moe_ffn(x, p, moe, every_expert)


def is_moe_layer(vm, pfx: str, cfg: UniversalConfig) -> bool:
    """A layer is MoE by its weights (so ``first_k_dense_replace``,
    ``decoder_sparse_step`` and ``mlp_only_layers`` need no rule here)."""
    return cfg.moe is not None and any(pfx + name in vm for name in (
        "mlp.gate.weight", "block_sparse_moe.gate.weight", "mlp.experts.gate_proj.weight",
        "mlp.experts.0.gate_proj.weight", "block_sparse_moe.experts.0.w1.weight"))


def build_moe_params(pb, pfx: str, cfg: UniversalConfig) -> dict:
    """Router, per-expert weights stacked to [E, ...] (Mixtral's
    ``block_sparse_moe.experts.N.w1/w3/w2``, ``mlp.experts.N.gate/up/
    down_proj`` or GGUF's pre-stacked ``mlp.experts.gate/up/down_proj``),
    DeepSeek's ``shared_experts`` or Qwen2-MoE's gated ``shared_expert``."""
    p: dict[str, Any] = {
        "router": pb.get(pfx + "mlp.gate.weight", pfx + "block_sparse_moe.gate.weight",
                         transpose=True),
        "correction_bias": pb.get(pfx + "mlp.gate.e_score_correction_bias",
                                  required=False, dtype=torch.float32),
    }
    if pfx + "mlp.experts.gate_proj.weight" in pb.vm:
        # GGUF's pre-stacked ffn_{gate,up,down}_exps: a stacked QuantTensor
        # (loader/varmap.py), or dense [E, out, in] placed as [E, in, out].
        for key, part in (("experts_gate", "gate_proj"), ("experts_up", "up_proj"),
                          ("experts_down", "down_proj")):
            p[key] = pb.get(pfx + f"mlp.experts.{part}.weight", transpose=True)
    else:
        stacks: dict[str, list] = {"experts_gate": [], "experts_up": [], "experts_down": []}
        for ei in range(cfg.moe.num_experts):
            hf, mx = pfx + f"mlp.experts.{ei}.", pfx + f"block_sparse_moe.experts.{ei}."
            for key, part, w in (("experts_gate", "gate_proj", "w1"),
                                 ("experts_up", "up_proj", "w3"),
                                 ("experts_down", "down_proj", "w2")):
                stacks[key].append(pb.get(hf + part + ".weight", mx + w + ".weight",
                                          transpose=True))
        for key, ws in stacks.items():
            p[key] = stack_quant(ws) if isinstance(ws[0], QuantTensor) else torch.stack(ws)
    for base in (pfx + "mlp.shared_experts.", pfx + "mlp.shared_expert."):
        sg = pb.get(base + "gate_proj.weight", transpose=True, required=False)
        if sg is not None:
            p["shared_gate"] = sg
            p["shared_up"] = pb.get(base + "up_proj.weight", transpose=True)
            p["shared_down"] = pb.get(base + "down_proj.weight", transpose=True)
            break
    seg = pb.get(pfx + "mlp.shared_expert_gate.weight", transpose=True, required=False)
    if seg is not None:
        p["shared_expert_gate"] = seg
    return p
