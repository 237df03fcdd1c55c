"""Llama-family forward over the contiguous KV cache.

Counterpart of ``blazr_tpu/models/llama.py`` (``forward`` :115,
``attention_block``, ``forward_embed`` / ``forward_layers_range`` /
``forward_head`` :219-316) for the llama and mistral kinds: fused or split
qkv and gate+up projections (every quantized one through ``quant_matmul``:
kernel B1, B3 or B4), GQA, the sliding window, rope scaling and
``layers.attend`` over the cache. K/V are written into the cache in place.

The MoE, plain-MLP (``fc``), parallel-residual, Gemma-norm and LayerNorm
branches of the JAX forward serve other families and raise
``NotImplementedError`` (ROADMAP queue A item 11); so does ring attention.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from ..config.model_config import UniversalConfig
from ..kvcache.contiguous import KVCache, advance, kv_length, write_layer
from .layers import (alibi_slopes, apply_rope, attend, device_scalar, linear,
                     rms_norm, rope_cos_sin, rope_frequencies, swiglu_mlp)

_LATER = "(ROADMAP queue A item 11)"


def check_config(cfg: UniversalConfig) -> None:
    """Raise for what this forward does not serve."""
    if cfg.model_type not in ("llama", "mistral") or cfg.attention is None \
            or cfg.attention.is_mla:
        raise NotImplementedError(
            f"the contiguous forward serves the llama/mistral kinds, not "
            f"{cfg.model_type!r} {_LATER}")
    if cfg.parallel_residual:
        raise NotImplementedError(f"parallel-residual blocks {_LATER}")
    if cfg.norm_type != "rmsnorm":
        raise NotImplementedError(f"{cfg.norm_type} blocks {_LATER}")
    if cfg.moe is not None:
        raise NotImplementedError(f"MoE layers {_LATER}")


def _check_layer(p: dict[str, Any]) -> None:
    if p.get("moe") is not None:
        raise NotImplementedError(f"MoE layers {_LATER}")
    if p.get("fc") is not None:
        raise NotImplementedError(f"plain (fc) MLPs {_LATER}")
    if p.get("post_attn_norm") is not None or p.get("post_ffw_norm") is not None:
        raise NotImplementedError(f"Gemma sandwich norms {_LATER}")


def project_qkv(p: dict[str, Any], cfg: UniversalConfig, x: torch.Tensor,
                cos: torch.Tensor, sin: torch.Tensor,
                alibi: Optional[torch.Tensor] = None):
    """q [B, T, H, D], k and v [B, T, H_kv, D] from x [B, T, hidden]: fused
    or split projections, the Qwen3 QK norm, and rope unless ALiBi."""
    att = cfg.attention
    b, t, _ = x.shape
    head_dim = att.resolved_head_dim(cfg.hidden_size)
    n_heads = att.num_heads
    n_kv = att.kv_heads()
    if p.get("qkv") is not None:
        qkv = linear(x, p["qkv"], p.get("qkv_bias"))
        q_dim = n_heads * head_dim
        kv_dim = n_kv * head_dim
        q = qkv[..., :q_dim].reshape(b, t, n_heads, head_dim)
        k = qkv[..., q_dim:q_dim + kv_dim].reshape(b, t, n_kv, head_dim)
        v = qkv[..., q_dim + kv_dim:].reshape(b, t, n_kv, head_dim)
    else:
        q = linear(x, p["q"], p.get("q_bias")).reshape(b, t, n_heads, head_dim)
        k = linear(x, p["k"], p.get("k_bias")).reshape(b, t, n_kv, head_dim)
        v = linear(x, p["v"], p.get("v_bias")).reshape(b, t, n_kv, head_dim)
    if p.get("q_norm") is not None:
        q = rms_norm(q, p["q_norm"], cfg.rms_norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.rms_norm_eps)
    if alibi is None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def attention_block(p: dict[str, Any], cfg: UniversalConfig, x: torch.Tensor,
                    cache: KVCache, layer: int, positions: torch.Tensor,
                    kv_len: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                    alibi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One attention block: projections, rope, in-place cache write, masked
    attention over the cache, output projection. x [B, T, H]; kv_len [B] is
    the valid length after this block's write."""
    b, t, _ = x.shape
    q, k, v = project_qkv(p, cfg, x, cos, sin, alibi)
    write_layer(cache, layer, k, v, positions)
    out = attend(q, cache.k[layer], cache.v[layer], q_positions=positions,
                 kv_len=kv_len, sliding_window=cfg.attention.sliding_window,
                 logit_softcap=cfg.attn_logit_softcapping,
                 k_scale=cache.k_scale[layer] if cache.quantized else None,
                 v_scale=cache.v_scale[layer] if cache.quantized else None,
                 alibi=alibi)
    out = out.reshape(b, t, q.shape[2] * q.shape[3]).to(x.dtype)
    return linear(out, p["o"], p.get("o_bias"))


def mlp(p: dict[str, Any], h: torch.Tensor) -> torch.Tensor:
    """Fused gate+up (or split SwiGLU) feed-forward."""
    if p.get("gateup") is not None:
        gu = linear(h, p["gateup"])
        inter = gu.shape[-1] // 2
        return linear(F.silu(gu[..., :inter]) * gu[..., inter:], p["down"])
    return swiglu_mlp(h, p["gate"], p["up"], p["down"])


def rope_and_alibi(cfg: UniversalConfig, positions: torch.Tensor):
    att = cfg.attention
    head_dim = att.resolved_head_dim(cfg.hidden_size)
    cos, sin = rope_cos_sin(positions, rope_frequencies(att, head_dim,
                                                        positions.device))
    alibi = (alibi_slopes(att.num_heads, positions.device) * head_dim ** -0.5
             if att.use_alibi else None)
    return cos, sin, alibi


def forward_embed(params: dict[str, Any], cfg: UniversalConfig,
                  tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings only."""
    x = params["embed"][tokens.to(torch.long)]
    if cfg.scale_embeddings:
        x = x * device_scalar(cfg.hidden_size ** 0.5, x.dtype, x.device)
    return x


def forward_layers_range(params: dict[str, Any], cfg: UniversalConfig,
                         hidden: torch.Tensor, cache: KVCache,
                         positions: torch.Tensor, start: int, end: int,
                         seq_lens: Optional[torch.Tensor] = None,
                         cache_layer_offset: int = 0) -> tuple[torch.Tensor, KVCache]:
    """Decoder layers [start, end) over hidden states [B, T, H] (the
    pipeline-stage forward). ``cache`` holds only this stage's layers;
    ``cache_layer_offset`` maps model layer index → cache slot. Advances
    the cache length in place."""
    check_config(cfg)
    cos, sin, alibi = rope_and_alibi(cfg, positions)
    kv_len = kv_length(cache, positions, seq_lens)
    x = hidden
    for li in range(start, end):
        p = params["layers"][li]
        _check_layer(p)
        h = rms_norm(x, p["input_norm"], cfg.rms_norm_eps)
        x = x + attention_block(p, cfg, h, cache, li - start + cache_layer_offset,
                                positions, kv_len, cos, sin, alibi)
        h = rms_norm(x, p["post_norm"], cfg.rms_norm_eps)
        x = x + mlp(p, h)
    advance(cache, positions, seq_lens)
    return x, cache


def forward_head(params: dict[str, Any], cfg: UniversalConfig,
                 hidden: torch.Tensor) -> torch.Tensor:
    """Final norm + LM head → float32 logits."""
    x = rms_norm(hidden, params["final_norm"], cfg.rms_norm_eps)
    lm_head = params.get("lm_head")
    if lm_head is None:                         # tied embeddings
        logits = x.to(torch.float32) @ params["embed"].t().to(x.dtype).to(torch.float32)
    else:
        logits = linear(x, lm_head)
    logits = logits.to(torch.float32)
    if cfg.final_logit_softcapping:
        c = cfg.final_logit_softcapping
        logits = torch.tanh(logits / c) * c
    return logits


def forward(params: dict[str, Any], cfg: UniversalConfig, tokens: torch.Tensor,
            cache: KVCache, positions: torch.Tensor,
            seq_lens: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, KVCache]:
    """Embeddings → decoder layers → final norm → logits [B, T, V] float32
    and the cache (written in place). Serves prefill (T = prompt length)
    and decode (T = 1); for bucketed prefill, pad positions point at the
    cache's trash slot and ``seq_lens`` carries the true lengths. The head
    runs over every position, as in the JAX package, so a quantized head
    sees the same row count in both."""
    x = forward_embed(params, cfg, tokens)
    x, cache = forward_layers_range(params, cfg, x, cache, positions, 0,
                                    len(params["layers"]), seq_lens)
    return forward_head(params, cfg, x), cache
