"""Llama-family forward over the paged KV cache.

Counterpart of ``blazr_tpu/models/llama_paged.py`` for the llama/mistral
family (no MoE, falcon or ring attention in this slice). K/V are written to
their slots in place; decode (``t == 1``) attends through kernel B2
(``attention.paged_attention``), prefill gathers each sequence's pages and
runs ``layers.attend``. The JAX package gates its kernel on
``head_dim % 128``, a TPU tiling rule; B2 takes head_dim 64 too.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from ..attention.paged_attention import paged_attention_decode
from ..config.model_config import UniversalConfig
from ..kvcache.paged import (PagedKVCache, gather_page_scales, gather_pages,
                             write_paged_layer)
from ..utils.device import DeviceLike, check_on, resolve_device
from .layers import (alibi_slopes, apply_rope, attend, linear, rms_norm,
                     rope_cos_sin, rope_frequencies, swiglu_mlp)


def _paged_attention_block(
    p: dict[str, Any],
    cfg: UniversalConfig,
    x: torch.Tensor,                  # [B, T, H]
    cache: PagedKVCache,
    layer: int,
    positions: torch.Tensor,          # [B, T]
    slot_mapping: torch.Tensor,       # [B, T]
    block_tables: torch.Tensor,       # [B, MB]
    seq_lens: torch.Tensor,           # [B] valid tokens incl. this step
    cos: torch.Tensor,
    sin: torch.Tensor,
    alibi: Optional[torch.Tensor],
) -> torch.Tensor:
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
        k = qkv[..., q_dim : q_dim + kv_dim].reshape(b, t, n_kv, head_dim)
        v = qkv[..., q_dim + kv_dim :].reshape(b, t, n_kv, head_dim)
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

    write_paged_layer(cache, layer, k, v, slot_mapping)

    if t == 1:
        out = paged_attention_decode(
            q[:, 0].contiguous(), cache.k[layer], cache.v[layer], block_tables,
            seq_lens, block_size=cache.block_size, num_blocks=cache.num_blocks,
            k_scale=cache.k_scale[layer] if cache.quantized else None,
            v_scale=cache.v_scale[layer] if cache.quantized else None,
            sliding_window=att.sliding_window or None,
            logit_softcap=cfg.attn_logit_softcapping or None,
            alibi=alibi, device=x.device)
    else:
        k_all, v_all = gather_pages(cache, layer, block_tables)
        ks_all = vs_all = None
        if cache.quantized:
            ks_all, vs_all = gather_page_scales(cache, layer, block_tables)
        out = attend(q, k_all, v_all, q_positions=positions, kv_len=seq_lens,
                     sliding_window=att.sliding_window,
                     logit_softcap=cfg.attn_logit_softcapping,
                     k_scale=ks_all, v_scale=vs_all, alibi=alibi)
    out = out.reshape(b, t, n_heads * head_dim).to(x.dtype)
    return linear(out, p["o"], p.get("o_bias"))


def forward_paged(
    params: dict[str, Any],
    cfg: UniversalConfig,
    tokens: torch.Tensor,             # [B, T] int
    cache: PagedKVCache,
    positions: torch.Tensor,          # [B, T]
    slot_mapping: torch.Tensor,       # [B, T]
    block_tables: torch.Tensor,       # [B, MB] int32
    seq_lens: torch.Tensor,           # [B] int32
    last_idx: Optional[torch.Tensor] = None,   # [B]: head on this pos only
    *,
    device: DeviceLike = None,
) -> tuple[torch.Tensor, PagedKVCache]:
    """Logits [B, T (or 1), V] float32 and the cache (written in place).
    Runs on ``device`` (default ``cuda``); params, cache and inputs must
    lie there."""
    dev = resolve_device(device)
    check_on(dev, params["embed"], cache.k, tokens, positions, slot_mapping,
             block_tables, seq_lens)
    if cfg.model_type not in ("llama", "mistral") or cfg.attention is None:
        raise NotImplementedError(
            f"forward_paged serves the llama/mistral family, not "
            f"{cfg.model_type!r} (ROADMAP queue A)")
    x = params["embed"][tokens.to(torch.long)]
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=x.dtype, device=dev)

    att = cfg.attention
    head_dim = att.resolved_head_dim(cfg.hidden_size)
    cos, sin = rope_cos_sin(positions, rope_frequencies(att, head_dim, dev))
    alibi = (alibi_slopes(att.num_heads, dev) * head_dim ** -0.5
             if att.use_alibi else None)

    for i, p in enumerate(params["layers"]):
        h = rms_norm(x, p["input_norm"], cfg.rms_norm_eps)
        x = x + _paged_attention_block(p, cfg, h, cache, i, positions,
                                       slot_mapping, block_tables, seq_lens,
                                       cos, sin, alibi)
        h = rms_norm(x, p["post_norm"], cfg.rms_norm_eps)
        if p.get("gateup") is not None:          # fused gate+up matmul
            gu = linear(h, p["gateup"])
            inter = gu.shape[-1] // 2
            x = x + linear(F.silu(gu[..., :inter]) * gu[..., inter:], p["down"])
        else:
            x = x + swiglu_mlp(h, p["gate"], p["up"], p["down"])

    if last_idx is not None:
        # Prefill needs the last position's logits only: slice before the
        # head so the [B, T, V] logits never materialize.
        idx = last_idx.to(torch.long)[:, None, None].expand(-1, 1, x.shape[-1])
        x = torch.gather(x, 1, idx)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    lm_head = params.get("lm_head")
    if lm_head is None:
        logits = x.to(torch.float32) @ params["embed"].t().to(x.dtype).to(torch.float32)
    else:
        logits = linear(x, lm_head)
    logits = logits.to(torch.float32)
    if cfg.final_logit_softcapping:
        c = cfg.final_logit_softcapping
        logits = torch.tanh(logits / c) * c
    return logits, cache
