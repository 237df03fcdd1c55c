"""Decoder forward over the paged KV cache.

Counterpart of ``blazr_tpu/models/llama_paged.py`` (``forward_paged``
:154-250) for the families of ``models/llama.py``, with the same
switches, the MoE FFN (JAX :193-196) and the same corrections to the
reference (no ring attention). K/V are written to their slots in place;
decode (``t == 1``) attends through kernel B2 (``attention.paged_attention``)
with the layer's window and score scale, prefill gathers each sequence's
pages and runs ``layers.attend``. The JAX package gates its kernel on
``head_dim % 128``, a TPU tiling rule; B2 takes any head_dim that is a
multiple of 32 up to 256 (Falcon's 64, Phi-3's 96).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..attention.paged_attention import paged_attention_decode
from ..config.model_config import UniversalConfig
from ..kvcache.paged import (PagedKVCache, gather_page_scales, gather_pages,
                             write_paged_layer)
from ..utils.device import DeviceLike, check_on, resolve_device
from .layers import attend, linear
from .llama import (check_config, decoder_layer, forward_embed, forward_head,
                    last_positions, project_qkv, rope_and_alibi)


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
    q, k, v = project_qkv(p, cfg, x, cos, sin, alibi)
    write_paged_layer(cache, layer, k, v, slot_mapping)
    window = att.layer_window(layer)
    scale = att.score_scale(q.shape[-1])

    if t == 1:
        out = paged_attention_decode(
            q[:, 0].contiguous(), cache.k[layer], cache.v[layer], block_tables,
            seq_lens, block_size=cache.block_size, num_blocks=cache.num_blocks,
            k_scale=cache.k_scale[layer] if cache.quantized else None,
            v_scale=cache.v_scale[layer] if cache.quantized else None,
            sliding_window=window, logit_softcap=cfg.attn_logit_softcapping or None,
            scale=scale, alibi=alibi, device=x.device)
    else:
        k_all, v_all = gather_pages(cache, layer, block_tables)
        ks_all = vs_all = None
        if cache.quantized:
            ks_all, vs_all = gather_page_scales(cache, layer, block_tables)
        out = attend(q, k_all, v_all, q_positions=positions, kv_len=seq_lens,
                     sliding_window=window, logit_softcap=cfg.attn_logit_softcapping,
                     scale=scale,
                     k_scale=ks_all, v_scale=vs_all, alibi=alibi)
    out = out.reshape(b, t, q.shape[2] * q.shape[3]).to(x.dtype)
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
    check_config(cfg)
    x = forward_embed(params, cfg, tokens)
    cos, sin, alibi = rope_and_alibi(cfg, positions)

    for i, p in enumerate(params["layers"]):
        x = decoder_layer(p, cfg, x, lambda h: _paged_attention_block(
            p, cfg, h, cache, i, positions, slot_mapping, block_tables, seq_lens,
            cos, sin, alibi))

    return forward_head(params, cfg, last_positions(x, last_idx)), cache
