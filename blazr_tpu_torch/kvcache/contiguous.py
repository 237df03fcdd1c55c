"""Contiguous (dense) layered KV cache.

Counterpart of ``blazr_tpu/kvcache/contiguous.py`` with the same layout:

    k, v: [num_layers, batch, capacity + 1, kv_heads, head_dim]

The extra last slot is the trash position that padded prefill writes land
in. Unlike the JAX cache (an immutable pytree whose writes are in place only
under buffer donation), ``write_layer`` and ``advance`` update the tensors
IN PLACE and return the same cache object.

int8 KV holds per-token-per-head absmax scales beside int8 values. int4 KV
holds the JAX package's values (range ±7, scale absmax/7) packed two to a
byte along head_dim (``[..., head_dim // 2]`` uint8, the even element in
the low nibble), half of int8's bytes as the JAX cache's ``jnp.int4``;
``layer_kv`` unpacks a layer where attention reads it, so inside a captured
decode graph the unpack is captured too.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..utils.device import DeviceLike, resolve_device
from .paged import quantize_tokens


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor                       # [L, B, S+1, H_kv, D] float or int8
    v: torch.Tensor
    length: torch.Tensor                  # [B] int32 valid entries per sequence
    # Quantized KV: per-token-per-head absmax scales; None = float mode.
    k_scale: Optional[torch.Tensor] = None   # [L, B, S+1, H_kv] f32
    v_scale: Optional[torch.Tensor] = None
    qmax: float = 127.0                   # 127 for int8 KV, 7 for int4 KV

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def packed(self) -> bool:
        """int4 values two to a byte."""
        return self.k.dtype == torch.uint8

    @property
    def capacity(self) -> int:
        """Usable capacity (one extra hidden slot absorbs padded writes)."""
        return self.k.shape[2] - 1

    @property
    def trash_position(self) -> int:
        """Write target for padding tokens: beyond every valid length, so
        masked attention never reads it."""
        return self.k.shape[2] - 1


def init_kv_cache(num_layers: int, batch: int, capacity: int, kv_heads: int,
                  head_dim: int, dtype: torch.dtype = torch.bfloat16,
                  quantized: bool = False, kv_dtype: str = "int8",
                  device: DeviceLike = None) -> KVCache:
    dev = resolve_device(device)
    shape = (num_layers, batch, capacity + 1, kv_heads, head_dim)
    length = torch.zeros((batch,), dtype=torch.int32, device=dev)
    if quantized:
        if kv_dtype not in ("int8", "int4"):
            raise ValueError(f"unknown quantized kv_dtype {kv_dtype!r}")
        if kv_dtype == "int4" and head_dim % 2:
            raise ValueError(f"int4 KV packs pairs along head_dim; {head_dim} is odd")
        store = ((*shape[:4], head_dim // 2), torch.uint8) if kv_dtype == "int4" \
            else (shape, torch.int8)
        return KVCache(
            k=torch.zeros(store[0], dtype=store[1], device=dev),
            v=torch.zeros(store[0], dtype=store[1], device=dev),
            length=length,
            k_scale=torch.zeros(shape[:4], dtype=torch.float32, device=dev),
            v_scale=torch.zeros(shape[:4], dtype=torch.float32, device=dev),
            qmax=7.0 if kv_dtype == "int4" else 127.0,
        )
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev), length=length)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 values in ±7 [..., D] → uint8 [..., D // 2], two's-complement
    nibbles, element 2i in the low nibble of byte i."""
    n = q.to(torch.int16) & 0xF
    return (n[..., 0::2] | (n[..., 1::2] << 4)).to(torch.uint8)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """The inverse of ``pack_int4``: uint8 [..., D // 2] → int8 [..., D]."""
    b = p.to(torch.int16)
    lo, hi = b & 0xF, b >> 4
    n = torch.stack((lo, hi), dim=-1).flatten(-2)
    return ((n ^ 8) - 8).to(torch.int8)


def layer_kv(cache: KVCache, layer: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Layer ``layer``'s K and V [B, S+1, H_kv, D] as attention reads them
    (int4 unpacked to int8 values)."""
    if cache.packed:
        return unpack_int4(cache.k[layer]), unpack_int4(cache.v[layer])
    return cache.k[layer], cache.v[layer]


def write_layer(cache: KVCache, layer: int, k_new: torch.Tensor,
                v_new: torch.Tensor, positions: torch.Tensor) -> KVCache:
    """Write new K/V [B, T, H, D] at absolute ``positions`` [B, T] of layer
    ``layer``, in place (ragged per-sequence positions allowed)."""
    b = k_new.shape[0]
    rows = torch.arange(b, device=positions.device)[:, None].expand_as(positions)
    pos = positions.to(torch.long)
    if cache.quantized:
        kq, ks = quantize_tokens(k_new, cache.qmax)
        vq, vs = quantize_tokens(v_new, cache.qmax)
        if cache.packed:
            kq, vq = pack_int4(kq), pack_int4(vq)
        cache.k[layer][rows, pos] = kq
        cache.v[layer][rows, pos] = vq
        cache.k_scale[layer][rows, pos] = ks
        cache.v_scale[layer][rows, pos] = vs
        return cache
    cache.k[layer][rows, pos] = k_new.to(cache.k.dtype)
    cache.v[layer][rows, pos] = v_new.to(cache.v.dtype)
    return cache


def kv_length(cache: KVCache, positions: torch.Tensor,
              seq_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Valid length per sequence after writing ``positions``: ``seq_lens``
    where given (bucketed prefill, pads on the trash slot), else one past
    the last position; never below the current length."""
    if seq_lens is not None:
        new = seq_lens.to(torch.int32)
    else:
        new = (positions.amax(dim=-1) + 1).to(torch.int32)
    return torch.maximum(cache.length, new)


def advance(cache: KVCache, positions: torch.Tensor,
            seq_lens: Optional[torch.Tensor] = None) -> KVCache:
    """Update the per-sequence lengths in place after writing ``positions``."""
    cache.length.copy_(kv_length(cache, positions, seq_lens))
    return cache
