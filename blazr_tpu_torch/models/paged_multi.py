"""Engine-facing dispatch of the paged forward and cache.

Counterpart of ``blazr_tpu/models/paged_multi.py`` (``make_paged_forward``
:410, ``init_engine_cache`` :429) for the families of ``models/llama.py``
(dense and MoE); MLA, Mamba2 and hybrid families raise (ROADMAP queue A
item 11).
"""

from __future__ import annotations

import torch

from ..config.model_config import UniversalConfig
from ..kvcache.paged import PagedKVCache, init_paged_cache
from ..utils.device import DeviceLike
from .llama import check_config
from .llama_paged import forward_paged


def make_paged_forward(cfg: UniversalConfig):
    """fwd(params, cfg, tokens, cache, positions, slots, block_tables,
    seq_lens, state_rows=None, last_idx=None)."""
    check_config(cfg)

    def fwd(params, cfg, tokens, cache, positions, slots, bts, seq_lens,
            state_rows=None, last_idx=None):
        return forward_paged(params, cfg, tokens, cache, positions, slots, bts,
                             seq_lens, last_idx=last_idx, device=tokens.device)
    return fwd


def init_engine_cache(cfg: UniversalConfig, num_blocks: int, block_size: int,
                      max_batch: int, dtype: torch.dtype = torch.bfloat16,
                      quantized: bool = False,
                      device: DeviceLike = None) -> tuple[PagedKVCache, bool]:
    """(cache, needs_state_rows) for the model's family."""
    check_config(cfg)
    att = cfg.attention
    return init_paged_cache(
        cfg.num_layers, num_blocks, block_size, att.kv_heads(),
        att.resolved_head_dim(cfg.hidden_size), dtype=dtype,
        quantized=quantized, device=device), False
