"""Engine-facing dispatch of the paged forward and cache.

Counterpart of ``blazr_tpu/models/paged_multi.py`` (``make_paged_forward``
:410, ``init_engine_cache`` :429) for the llama family only; MLA, Mamba2
and hybrid families are later slices (ROADMAP queue A).
"""

from __future__ import annotations

import torch

from ..config.model_config import UniversalConfig
from ..kvcache.paged import PagedKVCache, init_paged_cache
from ..utils.device import DeviceLike
from .llama_paged import forward_paged


def _check_llama(cfg: UniversalConfig) -> None:
    if (cfg.model_type not in ("llama", "mistral") or cfg.attention is None
            or cfg.attention.is_mla or cfg.ssm is not None or cfg.moe is not None):
        raise NotImplementedError(
            f"the port serves the llama/mistral family only, not "
            f"{cfg.model_type!r} (ROADMAP queue A)")


def make_paged_forward(cfg: UniversalConfig):
    """fwd(params, cfg, tokens, cache, positions, slots, block_tables,
    seq_lens, state_rows=None, last_idx=None)."""
    _check_llama(cfg)

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
    _check_llama(cfg)
    att = cfg.attention
    return init_paged_cache(
        cfg.num_layers, num_blocks, block_size, att.kv_heads(),
        att.resolved_head_dim(cfg.hidden_size), dtype=dtype,
        quantized=quantized, device=device), False
