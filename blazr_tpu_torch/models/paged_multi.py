"""Continuous-batching forwards and caches of the MLA, Mamba2 and hybrid
families.

Counterpart of ``blazr_tpu/models/paged_multi.py``: the engine calls one
step signature

    fwd(params, cfg, tokens, cache, positions, slots, block_tables,
        seq_lens, state_rows=None, last_idx=None) -> (logits, cache)

(the dense, MoE and MLA steps also take ``verify``, the speculative verify
step's forms; the recurrent families serve no speculation)

which ``registry.make_paged_forward`` looks up by family (the JAX
``resolve_paged_kind`` :54 and ``make_paged_forward`` :410 are
``registry.resolve_paged_kind`` and ``registry.FAMILY_KINDS``); the dense
and MoE families take ``llama_paged.forward_paged``, and this module holds
the others:

  * mla: the compressed latent in pages on the same block allocator and
    tables as the KV cache (``PagedMLACache`` :73, ``_paged_mla_block``
    :132), one trash slot, bf16 or int8 latents;
  * mamba2: a pool of state rows [L, max_batch + 1, ...] whose last row is
    the trash row pad rows point at (``init_ssm_slots`` :254,
    ``mamba2_forward_slots`` :285); ``state_rows`` [B] (a tensor on the
    device) picks each batch row's slot, and the blocks read and write the
    pool in place, so a captured decode graph holds it;
  * hybrid: paged KV on the attention layers (B2 at decode) and state rows
    on the Mamba2 layers, in one object (``HybridPagedState`` :305).

Every cache is written in place and returned as the same object.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..config.model_config import LAYER_MAMBA2, UniversalConfig
from ..kvcache.paged import PagedKVCache, init_paged_cache, page_slot_index, quantize_tokens
from ..kvcache.ssm_state import SSMState, init_ssm_state
from ..utils.device import DeviceLike, resolve_device
from . import llama, mamba2, mla
from .hybrid import layer_counts
from .layers import linear
from .llama_paged import _paged_attention_block


# ---------------------------------------------------------------------------
# MLA: the latent in pages
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PagedMLACache:
    """latent [L, NB·BS + 1, kv_lora], k_rope [L, NB·BS + 1, d_rope] (the
    last slot is the trash slot), per-slot scales [L, NB·BS + 1] f32 in the
    int8 mode."""

    latent: torch.Tensor
    k_rope: torch.Tensor
    block_size: int
    num_blocks: int
    latent_scale: Optional[torch.Tensor] = None
    k_rope_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.latent_scale is not None

    @property
    def trash_slot(self) -> int:
        return self.latent.shape[1] - 1


def init_paged_mla_cache(cfg: UniversalConfig, num_blocks: int, block_size: int,
                         dtype: torch.dtype = torch.bfloat16, quantized: bool = False,
                         device: DeviceLike = None) -> PagedMLACache:
    dev = resolve_device(device)
    att = cfg.attention
    ns = num_blocks * block_size + 1
    shape_c, shape_r = (cfg.num_layers, ns, att.kv_latent_dim), (cfg.num_layers, ns, att.d_rope)
    if quantized:
        return PagedMLACache(
            latent=torch.zeros(shape_c, dtype=torch.int8, device=dev),
            k_rope=torch.zeros(shape_r, dtype=torch.int8, device=dev),
            block_size=block_size, num_blocks=num_blocks,
            latent_scale=torch.zeros(shape_c[:2], dtype=torch.float32, device=dev),
            k_rope_scale=torch.zeros(shape_r[:2], dtype=torch.float32, device=dev))
    return PagedMLACache(latent=torch.zeros(shape_c, dtype=dtype, device=dev),
                         k_rope=torch.zeros(shape_r, dtype=dtype, device=dev),
                         block_size=block_size, num_blocks=num_blocks)


def _gather_latent_pages(cache: PagedMLACache, layer: int, block_tables: torch.Tensor):
    """[B, MB] tables → (latent [B, MB·BS, r], k_rope [B, MB·BS, d_rope],
    their scales [B, MB·BS] or None)."""
    idx = page_slot_index(cache.block_size, block_tables)
    if cache.quantized:
        return (cache.latent[layer][idx], cache.k_rope[layer][idx],
                cache.latent_scale[layer][idx], cache.k_rope_scale[layer][idx])
    return cache.latent[layer][idx], cache.k_rope[layer][idx], None, None


def _paged_mla_block(p, cfg, x, cache: PagedMLACache, layer, positions, slot_mapping,
                     block_tables, seq_lens, cos, sin) -> torch.Tensor:
    q_nope, q_rope, c, k_rope = mla.project(p, cfg, x, cos, sin)
    b, t, _ = x.shape
    flat = slot_mapping.reshape(-1).to(torch.long)
    if cache.quantized:
        cq, cs = quantize_tokens(c)
        rq, rs = quantize_tokens(k_rope)
        cache.latent[layer].index_copy_(0, flat, cq.reshape(b * t, -1))
        cache.k_rope[layer].index_copy_(0, flat, rq.reshape(b * t, -1))
        cache.latent_scale[layer].index_copy_(0, flat, cs.reshape(b * t))
        cache.k_rope_scale[layer].index_copy_(0, flat, rs.reshape(b * t))
    else:
        cache.latent[layer].index_copy_(0, flat, c.reshape(b * t, -1).to(cache.latent.dtype))
        cache.k_rope[layer].index_copy_(0, flat,
                                        k_rope.reshape(b * t, -1).to(cache.k_rope.dtype))
    c_all, kr_all, c_sc, r_sc = _gather_latent_pages(cache, layer, block_tables)
    kv_pos = torch.arange(c_all.shape[1], dtype=torch.int32, device=x.device)
    mask = ((kv_pos[None, :] < seq_lens[:, None])[:, None, :]
            & (kv_pos[None, None, :] <= positions[:, :, None]))
    out = mla.absorbed_attention(p, cfg, q_nope, q_rope, c_all, kr_all, c_sc, r_sc,
                                 mask, x.dtype)
    return linear(out, p["o"])


def mla_forward_paged(params, cfg, tokens, cache: PagedMLACache, positions, slot_mapping,
                      block_tables, seq_lens, state_rows=None, last_idx=None, verify=False):
    """``verify`` (the speculative verify step) takes MoE's decode form; the
    latent attention is the plain gather at every T."""
    x = llama.forward_embed(params, cfg, tokens)
    cos, sin = mla.rope(cfg, positions)
    for i, p in enumerate(params["layers"]):
        x = mla.decoder_layer(p, cfg, x, lambda h: _paged_mla_block(
            p, cfg, h, cache, i, positions, slot_mapping, block_tables, seq_lens, cos, sin),
            every_expert=verify)
    return llama.forward_head(params, cfg, llama.last_positions(x, last_idx)), cache


# ---------------------------------------------------------------------------
# Mamba2: state slots
# ---------------------------------------------------------------------------

def init_ssm_slots(cfg: UniversalConfig, max_batch: int, num_layers: Optional[int] = None,
                   device: DeviceLike = None) -> SSMState:
    """A pool of ``max_batch + 1`` state rows; the last is the trash row."""
    return init_ssm_state(cfg, max_batch + 1, num_layers=num_layers, device=device)


def zero_ssm_row(state: SSMState, row: int) -> SSMState:
    """Zero one sequence's row in place (an admission, or a restart after
    preemption)."""
    state.conv[:, row].zero_()
    state.ssm[:, row].zero_()
    state.length[row] = 0
    return state


def mamba2_forward_slots(params, cfg, tokens, pool: SSMState, positions, slot_mapping,
                         block_tables, seq_lens, state_rows=None, last_idx=None):
    """The pure-Mamba2 step over the pool's rows ``state_rows`` (pages
    unused: the state is O(1))."""
    logits, _ = mamba2.forward(params, cfg, tokens, pool, positions, seq_lens,
                               last_idx=last_idx, rows=state_rows.to(torch.long))
    return logits, pool


# ---------------------------------------------------------------------------
# Hybrid: paged KV on the attention layers, state rows on the Mamba2 layers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HybridPagedState:
    kv: PagedKVCache
    ssm: SSMState                       # the slot pool [L_mamba, max_batch + 1, ...]

    @property
    def block_size(self) -> int:
        return self.kv.block_size

    @property
    def trash_slot(self) -> int:
        return self.kv.trash_slot

    @property
    def quantized(self) -> bool:
        return self.kv.quantized


def init_hybrid_paged_state(cfg: UniversalConfig, num_blocks: int, block_size: int,
                            max_batch: int, dtype: torch.dtype = torch.bfloat16,
                            quantized: bool = False,
                            device: DeviceLike = None) -> HybridPagedState:
    n_attn, n_mamba = layer_counts(cfg)
    att = cfg.attention
    return HybridPagedState(
        kv=init_paged_cache(max(n_attn, 1), num_blocks, block_size, att.kv_heads(),
                            att.resolved_head_dim(cfg.hidden_size), dtype=dtype,
                            quantized=quantized, device=device),
        ssm=init_ssm_slots(cfg, max_batch, num_layers=max(n_mamba, 1), device=device))


def hybrid_forward_paged(params, cfg, tokens, state: HybridPagedState, positions,
                         slot_mapping, block_tables, seq_lens, state_rows=None,
                         last_idx=None):
    x = llama.forward_embed(params, cfg, tokens)
    cos, sin, alibi = llama.rope_and_alibi(cfg, positions)
    rows = state_rows.to(torch.long)
    types = cfg.layer_types()
    attn_i = mamba_i = 0
    for i, p in enumerate(params["layers"]):
        if types[i] == LAYER_MAMBA2:
            j = mamba_i
            mamba_i += 1
            x = mamba2.decoder_layer(p, cfg, x, lambda h: mamba2.mamba2_block(
                p, cfg, h, state.ssm, j, rows))
        else:
            j = attn_i
            attn_i += 1
            x = mamba2.decoder_layer(p, cfg, x, lambda h: _paged_attention_block(
                p, cfg, h, state.kv, j, positions, slot_mapping, block_tables, seq_lens,
                cos, sin, alibi))
    state.ssm.length.index_add_(0, rows, torch.full_like(rows, tokens.shape[1],
                                                         dtype=torch.int32))
    return llama.forward_head(params, cfg, llama.last_positions(x, last_idx)), state


# ---------------------------------------------------------------------------
# The engine's helpers for any family's cache
# ---------------------------------------------------------------------------

def zero_state_rows(cache, row: int):
    """Zero a sequence's state row in whichever cache holds the pool."""
    if isinstance(cache, SSMState):
        zero_ssm_row(cache, row)
    elif isinstance(cache, HybridPagedState):
        zero_ssm_row(cache.ssm, row)
    return cache


def trash_slot(cache) -> int:
    """The slot pad tokens write to (0 where there are no pages)."""
    return getattr(cache, "trash_slot", 0)
