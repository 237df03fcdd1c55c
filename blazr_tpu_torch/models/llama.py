"""Decoder forward over the contiguous KV cache.

Counterpart of ``blazr_tpu/models/llama.py`` (``forward`` :115-217,
``attention_block``, ``forward_embed`` / ``forward_layers_range`` /
``forward_head`` :219-316) for the dense families of the JAX package's
switches: llama, mistral, qwen2 (qkv biases), qwen3 (QK norm), phi3 (fused
qkv and gate+up), gemma (the +1 norm offset, scaled embeddings, GeGLU),
gemma2 (also sandwich norms, attention and final softcaps, a window on the
even layers), starcoder2 (LayerNorm with biases, a plain GELU MLP) and
falcon (parallel residual blocks, ALiBi in the rw layout), and the MoE
families on the same forward (mixtral, qwen2_moe, qwen3_moe: ``models/moe.py``
in place of the MLP where a layer's weights have experts, JAX
``llama.py:158-161, 265-268``). Every quantized projection goes through
``quant_matmul`` (kernel B1, B3 or B4); K/V are written into the cache in
place.

Where the JAX package is wrong this forward follows transformers, the
reference its goldens use (ROADMAP §C): Gemma2 slides its window on the
layers its config names (``AttentionConfig.layer_window``) and scales the
scores by ``query_pre_attn_scalar ** -0.5``; a fused gate+up takes the
family's activation; ``forward_layers_range`` and ``forward_head`` keep
the Gemma norm offset and sandwich norms of ``forward``. ``check_config``
says which families the port serves; the MLA, Mamba2 and hybrid forwards
live in ``models/mla.py``, ``models/mamba2.py`` and ``models/hybrid.py``.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..config.model_config import UniversalConfig
from ..kvcache.contiguous import KVCache, advance, kv_length, write_layer
from .layers import (activation, alibi_slopes, apply_rope, attend, device_scalar,
                     layer_norm, linear, plain_mlp, rms_norm, rope_cos_sin,
                     rope_frequencies)
from .moe import moe_forward

# The families the port serves: the JAX package's dense switches and the
# MoE families on the llama forwards, DeepSeek's MLA (``models/mla.py``),
# Mamba2 (``models/mamba2.py``) and the Mamba2/attention hybrids
# (``models/hybrid.py``; any model type whose layer types mix the two).
SERVED_FAMILIES = ("llama", "mistral", "qwen2", "qwen3", "phi3", "gemma", "gemma2",
                   "starcoder2", "falcon", "mixtral", "qwen2_moe", "qwen3_moe",
                   "deepseek", "mamba2", "bamba")


def _unserved(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not served by blazr_tpu_torch yet "
                               f"(ROADMAP queue A item {item})")


def check_config(cfg: UniversalConfig) -> None:
    """Raise for what the port does not serve: Mamba3 mixers (ROADMAP queue
    A item 11), vision towers (item 12), and model types outside
    ``SERVED_FAMILIES`` that are neither MLA nor a Mamba2 hybrid."""
    if cfg.ssm is not None and cfg.ssm.variant == "mamba3":
        raise _unserved("the Mamba3 mixer", "11")
    if cfg.vision is not None:
        raise _unserved("a vision tower", "12")
    types = set(cfg.layer_types())
    recurrent = cfg.ssm is not None and "mamba2" in types
    attention = cfg.attention is not None and (
        cfg.attention.is_mla or cfg.model_type in SERVED_FAMILIES)
    if not (recurrent or (attention and "mamba2" not in types)):
        raise NotImplementedError(
            f"the port serves the families {', '.join(SERVED_FAMILIES)}, MLA models "
            f"and Mamba2 hybrids, not {cfg.model_type!r}")


def norm_offset(cfg: UniversalConfig) -> float:
    """Gemma's RMSNorm scales by (1 + w)."""
    return 1.0 if cfg.model_type in ("gemma", "gemma2") else 0.0


def norm(cfg: UniversalConfig, h: torch.Tensor, w: torch.Tensor,
         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The family's block norm: LayerNorm (starcoder2, falcon) or RMSNorm."""
    if cfg.norm_type == "layernorm":
        return layer_norm(h, w, bias, cfg.rms_norm_eps)
    return rms_norm(h, w, cfg.rms_norm_eps, norm_offset(cfg))


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
                    alibi: Optional[torch.Tensor] = None,
                    model_layer: Optional[int] = None) -> torch.Tensor:
    """One attention block: projections, rope, in-place cache write, masked
    attention over the cache, output projection. x [B, T, H]; kv_len [B] is
    the valid length after this block's write; ``layer`` is the cache slot,
    ``model_layer`` (default ``layer``) the decoder layer whose window
    applies."""
    att = cfg.attention
    b, t, _ = x.shape
    q, k, v = project_qkv(p, cfg, x, cos, sin, alibi)
    write_layer(cache, layer, k, v, positions)
    out = attend(q, cache.k[layer], cache.v[layer], q_positions=positions,
                 kv_len=kv_len,
                 sliding_window=att.layer_window(layer if model_layer is None
                                                 else model_layer),
                 logit_softcap=cfg.attn_logit_softcapping,
                 scale=att.score_scale(q.shape[-1]),
                 k_scale=cache.k_scale[layer] if cache.quantized else None,
                 v_scale=cache.v_scale[layer] if cache.quantized else None,
                 alibi=alibi)
    out = out.reshape(b, t, q.shape[2] * q.shape[3]).to(x.dtype)
    return linear(out, p["o"], p.get("o_bias"))


def mlp(p: dict[str, Any], cfg: UniversalConfig, h: torch.Tensor) -> torch.Tensor:
    """The layer's feed-forward: MoE (``moe.moe_forward``), plain (fc,
    starcoder2/falcon), fused gate+up, or split gated; the gate takes GELU
    for Gemma, else SiLU."""
    if p.get("moe") is not None:
        return moe_forward(h, p["moe"], cfg.moe)
    if p.get("fc") is not None:
        return plain_mlp(h, p["fc"], p.get("fc_bias"), p["down"], p.get("down_bias"),
                         act=cfg.hidden_act)
    act = "gelu" if norm_offset(cfg) else "silu"
    if p.get("gateup") is not None:
        gu = linear(h, p["gateup"])
        inter = gu.shape[-1] // 2
        return linear(activation(gu[..., :inter], act) * gu[..., inter:], p["down"])
    return linear(activation(linear(h, p["gate"]), act) * linear(h, p["up"]), p["down"])


def decoder_layer(p: dict[str, Any], cfg: UniversalConfig, x: torch.Tensor,
                  attn) -> torch.Tensor:
    """One decoder layer around ``attn(h) → attention output``: the
    sequential block (with Gemma2's sandwich norms where the layer has them)
    or Falcon's parallel block, where attention and the MLP read the same
    normed input (the new architecture's own ``ln_mlp`` in ``post_norm``)."""
    h = norm(cfg, x, p["input_norm"], p.get("input_norm_bias"))
    attn_out = attn(h)
    if cfg.parallel_residual:
        if p.get("post_norm") is not None:
            h = norm(cfg, x, p["post_norm"], p.get("post_norm_bias"))
        return x + attn_out + mlp(p, cfg, h)
    if p.get("post_attn_norm") is not None:
        attn_out = rms_norm(attn_out, p["post_attn_norm"], cfg.rms_norm_eps,
                            norm_offset(cfg))
    x = x + attn_out
    h = norm(cfg, x, p["post_norm"], p.get("post_norm_bias"))
    mlp_out = mlp(p, cfg, h)
    if p.get("post_ffw_norm") is not None:
        mlp_out = rms_norm(mlp_out, p["post_ffw_norm"], cfg.rms_norm_eps,
                           norm_offset(cfg))
    return x + mlp_out


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
        slot = li - start + cache_layer_offset
        x = decoder_layer(p, cfg, x, lambda h: attention_block(
            p, cfg, h, cache, slot, positions, kv_len, cos, sin, alibi,
            model_layer=li))
    advance(cache, positions, seq_lens)
    return x, cache


def last_positions(x: torch.Tensor, last_idx: Optional[torch.Tensor]) -> torch.Tensor:
    """x [B, T, H] at each row's ``last_idx`` [B] → [B, 1, H]; x where None.
    A prefill needs the last position's logits only: slicing before the head
    keeps the [B, T, V] logits from materializing."""
    if last_idx is None:
        return x
    return torch.gather(x, 1, last_idx.to(torch.long)[:, None, None].expand(-1, 1, x.shape[-1]))


def forward_head(params: dict[str, Any], cfg: UniversalConfig,
                 hidden: torch.Tensor) -> torch.Tensor:
    """Final norm + LM head → float32 logits, Gemma2's final softcap last."""
    x = norm(cfg, hidden, params["final_norm"], params.get("final_norm_bias"))
    lm_head = params.get("lm_head")
    if lm_head is None:                         # tied embeddings
        # Products in x's dtype summed in f32, as the JAX dot's
        # preferred_element_type. On the card a 16-bit x takes cuBLAS's
        # f32-output GEMM: an f32 copy of the [V, H] table would cost 3.7 GB
        # of graph pool and 5 ms a step at Gemma2-9B's 256k vocab.
        w = params["embed"].t().to(x.dtype)
        if x.is_cuda and x.dtype != torch.float32:
            logits = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
            logits = logits.reshape(*x.shape[:-1], -1)
        else:
            logits = x.to(torch.float32) @ w.to(torch.float32)
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
