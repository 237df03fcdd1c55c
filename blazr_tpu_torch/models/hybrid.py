"""Hybrid Mamba2 + attention models.

Counterpart of ``blazr_tpu/models/hybrid.py`` (``HybridState`` :29,
``init_hybrid_state`` :45, ``forward`` :58, ``build_hybrid_params`` :127):
each layer is a Mamba2 mixer or llama attention by ``cfg.layer_types()``,
over one state that holds a contiguous KV cache for the attention layers
and an SSM state for the Mamba2 layers, each sized to its own layer count.
Every layer takes the FFN it carries (``mamba2.decoder_layer``). Both parts
are written in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..config.model_config import LAYER_MAMBA2, UniversalConfig
from ..kvcache.contiguous import KVCache, advance, init_kv_cache, kv_length
from ..kvcache.ssm_state import SSMState, init_ssm_state
from ..utils.device import DeviceLike, resolve_device
from . import llama, mamba2


@dataclasses.dataclass
class HybridState:
    kv: KVCache
    ssm: SSMState

    @property
    def length(self) -> torch.Tensor:
        return self.kv.length

    @property
    def trash_position(self) -> int:
        return self.kv.trash_position

    def reset_(self) -> "HybridState":
        """A new sequence: lengths to zero and the recurrent state zeroed."""
        self.kv.length.zero_()
        self.ssm.reset_()
        return self


def layer_counts(cfg: UniversalConfig) -> tuple[int, int]:
    """(attention layers, Mamba2 layers)."""
    types = cfg.layer_types()
    n_mamba = sum(t == LAYER_MAMBA2 for t in types)
    return len(types) - n_mamba, n_mamba


def init_hybrid_state(cfg: UniversalConfig, batch: int, capacity: int,
                      dtype: torch.dtype = torch.bfloat16,
                      device: DeviceLike = None) -> HybridState:
    dev = resolve_device(device)
    n_attn, n_mamba = layer_counts(cfg)
    att = cfg.attention
    return HybridState(
        kv=init_kv_cache(max(n_attn, 1), batch, capacity, att.kv_heads(),
                         att.resolved_head_dim(cfg.hidden_size), dtype=dtype, device=dev),
        ssm=init_ssm_state(cfg, batch, num_layers=max(n_mamba, 1), device=dev))


def forward(params: dict[str, Any], cfg: UniversalConfig, tokens: torch.Tensor,
            state: HybridState, positions: torch.Tensor,
            seq_lens: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, HybridState]:
    """Logits [B, T, V] f32 and the state (written in place). Every token
    enters the Mamba2 layers' scans, so a caller never pads."""
    x = llama.forward_embed(params, cfg, tokens)
    cos, sin, alibi = llama.rope_and_alibi(cfg, positions)
    kv_len = kv_length(state.kv, positions, seq_lens)
    types = cfg.layer_types()
    attn_i = mamba_i = 0
    for i, p in enumerate(params["layers"]):
        if types[i] == LAYER_MAMBA2:
            j = mamba_i
            mamba_i += 1
            x = mamba2.decoder_layer(p, cfg, x, lambda h: mamba2.mamba2_block(
                p, cfg, h, state.ssm, j))
        else:
            j = attn_i
            attn_i += 1
            x = mamba2.decoder_layer(p, cfg, x, lambda h: llama.attention_block(
                p, cfg, h, state.kv, j, positions, kv_len, cos, sin, alibi,
                model_layer=i))
    advance(state.kv, positions, seq_lens)
    state.ssm.length.add_(tokens.shape[1])
    return llama.forward_head(params, cfg, x), state


def build_hybrid_params(cfg: UniversalConfig, vm, dtype: torch.dtype,
                        device: torch.device) -> dict:
    """HF-style names: attention layers ``self_attn.*`` (the llama layer
    builder), Mamba2 layers ``mixer.*`` or ``mamba.*`` with an optional
    ``mlp.*`` FFN behind ``post_attention_layernorm`` or ``pre_ff_layernorm``."""
    from .registry import ParamBuilder, build_llama_layer_params

    pb = ParamBuilder(vm, dtype, device)
    layers = []
    for i, t in enumerate(cfg.layer_types()):
        pfx = f"model.layers.{i}."
        if t != LAYER_MAMBA2:
            layers.append(build_llama_layer_params(pb, i, cfg))
            continue
        p = mamba2.mamba_layer_params(pb, (pfx,), norms=("input_layernorm.weight",
                                                         "norm.weight"))
        gate = pb.get(pfx + "mlp.gate_proj.weight", transpose=True, required=False)
        if gate is not None:
            p["post_norm"] = pb.get(pfx + "post_attention_layernorm.weight",
                                    pfx + "pre_ff_layernorm.weight")
            p["gate"] = gate
            p["up"] = pb.get(pfx + "mlp.up_proj.weight", transpose=True)
            p["down"] = pb.get(pfx + "mlp.down_proj.weight", transpose=True)
        layers.append(p)
    params = {
        "embed": pb.get("model.embed_tokens.weight"),
        "final_norm": pb.get("model.norm.weight", "model.final_layernorm.weight"),
        "layers": layers,
        "lm_head": pb.get("lm_head.weight", transpose=True, required=False),
    }
    if params["lm_head"] is None and not cfg.tie_word_embeddings:
        cfg.tie_word_embeddings = True
    return params
