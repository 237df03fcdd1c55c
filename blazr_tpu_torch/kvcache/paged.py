"""Paged KV cache on the device.

Counterpart of ``blazr_tpu/kvcache/paged.py`` with the same layout:

    k, v: [num_layers, num_blocks * block_size + 1, kv_heads, head_dim]

The last slot is a trash slot that padded writes land in. Block tables are
padded with ``PAD_BLOCK``. Unlike the JAX cache (an immutable pytree that
every write replaces), ``write_paged_layer`` writes IN PLACE into the
cache's tensors and returns the same cache object.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device

PAD_BLOCK = 0x7FFFFFFF  # padded block-table entries (never dereferenced)


@dataclasses.dataclass
class PagedKVCache:
    k: torch.Tensor                       # [L, NB*BS + 1, H_kv, D]
    v: torch.Tensor
    block_size: int
    num_blocks: int
    # int8 KV mode: per-slot-per-head absmax scales; None = float mode.
    k_scale: Optional[torch.Tensor] = None   # [L, NB*BS + 1, H_kv] f32
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def num_layers(self) -> int:
        return self.k.shape[0]

    @property
    def kv_heads(self) -> int:
        return self.k.shape[2]

    @property
    def head_dim(self) -> int:
        return self.k.shape[3]

    @property
    def trash_slot(self) -> int:
        return self.k.shape[1] - 1


def init_paged_cache(num_layers: int, num_blocks: int, block_size: int,
                     kv_heads: int, head_dim: int,
                     dtype: torch.dtype = torch.bfloat16,
                     quantized: bool = False,
                     device: DeviceLike = None) -> PagedKVCache:
    dev = resolve_device(device)
    shape = (num_layers, num_blocks * block_size + 1, kv_heads, head_dim)
    if quantized:
        return PagedKVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=dev),
            v=torch.zeros(shape, dtype=torch.int8, device=dev),
            block_size=block_size, num_blocks=num_blocks,
            k_scale=torch.zeros(shape[:3], dtype=torch.float32, device=dev),
            v_scale=torch.zeros(shape[:3], dtype=torch.float32, device=dev),
        )
    return PagedKVCache(
        k=torch.zeros(shape, dtype=dtype, device=dev),
        v=torch.zeros(shape, dtype=dtype, device=dev),
        block_size=block_size, num_blocks=num_blocks,
    )


def quantize_tokens(x: torch.Tensor, qmax: float = 127.0
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., D] float → (int8 values in ±qmax, [...] absmax scales); the
    scheme of ``blazr_tpu/kvcache/contiguous.py::_quantize_tokens`` (qmax 127
    for int8 KV, 7 for int4 KV)."""
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-8) / qmax
    q = torch.clamp(torch.round(xf / scale[..., None]), -qmax, qmax)
    return q.to(torch.int8), scale


def write_paged_layer(cache: PagedKVCache, layer: int, k_new: torch.Tensor,
                      v_new: torch.Tensor,
                      slot_mapping: torch.Tensor) -> PagedKVCache:
    """Scatter [B, T, H, D] new K/V into flat slots [B, T] (trash slot for
    padding), in place."""
    b, t, h, d = k_new.shape
    slots = slot_mapping.reshape(-1).to(torch.long)
    if cache.quantized:
        kq, ks = quantize_tokens(k_new)
        vq, vs = quantize_tokens(v_new)
        cache.k[layer].index_copy_(0, slots, kq.reshape(b * t, h, d))
        cache.v[layer].index_copy_(0, slots, vq.reshape(b * t, h, d))
        cache.k_scale[layer].index_copy_(0, slots, ks.reshape(b * t, h))
        cache.v_scale[layer].index_copy_(0, slots, vs.reshape(b * t, h))
        return cache
    cache.k[layer].index_copy_(0, slots,
                               k_new.reshape(b * t, h, d).to(cache.k.dtype))
    cache.v[layer].index_copy_(0, slots,
                               v_new.reshape(b * t, h, d).to(cache.v.dtype))
    return cache


def page_slot_index(block_size: int, block_tables: torch.Tensor) -> torch.Tensor:
    """[B, MB] block tables → flat pool slot indices [B, MB*BS]."""
    b, mb = block_tables.shape
    safe = torch.where(block_tables == PAD_BLOCK,
                       torch.zeros_like(block_tables), block_tables).to(torch.long)
    offs = torch.arange(block_size, dtype=torch.long, device=block_tables.device)
    return (safe[:, :, None] * block_size + offs[None, None, :]).reshape(
        b, mb * block_size)


def gather_pages(cache: PagedKVCache, layer: int,
                 block_tables: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, MB] block tables → (k, v) [B, MB*BS, H, D] (prefill attention)."""
    idx = page_slot_index(cache.block_size, block_tables)
    return cache.k[layer][idx], cache.v[layer][idx]


def gather_page_scales(cache: PagedKVCache, layer: int,
                       block_tables: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 mode: scales with the same slot indexing → [B, MB*BS, H]."""
    idx = page_slot_index(cache.block_size, block_tables)
    return cache.k_scale[layer][idx], cache.v_scale[layer][idx]


# ---------------------------------------------------------------------------
# Host-side helpers (fixed-shape padding discipline)
# ---------------------------------------------------------------------------

def compute_slot_mapping(block_table: list[int], start_pos: int, num_tokens: int,
                         block_size: int, trash_slot: int,
                         pad_to: Optional[int] = None) -> np.ndarray:
    """Flat slots for tokens [start_pos, start_pos+num_tokens) of one
    sequence."""
    width = pad_to if pad_to is not None else num_tokens
    out = np.full((width,), trash_slot, dtype=np.int32)
    for i in range(num_tokens):
        p = start_pos + i
        out[i] = block_table[p // block_size] * block_size + p % block_size
    return out


def pad_block_table(blocks: list[int], max_blocks: int) -> np.ndarray:
    """[MB]-padded block table."""
    out = np.full((max_blocks,), PAD_BLOCK, dtype=np.int32)
    out[: len(blocks)] = blocks
    return out
