"""Kernel B2 (paged decode attention): wrapper, launch count and plain version.

The kernel itself is ``csrc/paged_attention.cu`` (CUDA C++ for sm_90a); it
replaces ``blazr_tpu/attention/paged_attention.py::_pa_kernel`` and
``_pa_attend_block``. Its note says what bounds it on the H100 and how its
design answers that.

Layout contract (``kvcache.paged.PagedKVCache``, one layer):
    q            : [B, H_q, D]            one decode token per sequence
    k_cache, v   : [NB*BS(+1 trash), H_kv, D]
    block_tables : [B, MB] int32 (PAD_BLOCK beyond each sequence)
    seq_lens     : [B] int32 valid tokens (incl. the current one)
    k/v_scale    : [NB*BS(+1), H_kv] float32 (int8 KV only)
Output: [B, H_q, D] in q's dtype.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from ..kvcache.paged import page_slot_index
from ..utils import cuda_build
from ..utils.device import DeviceLike, check_on, resolve_device

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}
# The split plan: the most blocks one wave holds (two a SM on 132 SMs; a
# second, partial wave costs more than fewer splits save: the split sweep of
# chip_smoke.py), and the fewest keys a split takes.
_TARGET_BLOCKS = 264
_MIN_SPLIT_KEYS = 128


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("paged_attention")
    fn = lib.pa_decode_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_float] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def walk_slots(max_blocks: int, block_size: int, sliding_window: Optional[int]) -> int:
    """Table slots B2 walks for a sequence at most: the table width, or
    under a window ``min(MB, W/BS + 2)`` from the first in-window slot."""
    if sliding_window:
        return min(max_blocks, sliding_window // block_size + 2)
    return max_blocks


def min_split_slots(block_size: int) -> int:
    """The fewest table slots a split takes where the walk has them: the
    slots of _MIN_SPLIT_KEYS keys."""
    return max(1, -(-_MIN_SPLIT_KEYS // block_size))


@functools.lru_cache(maxsize=None)
def split_plan(batch: int, num_kv_heads: int, max_blocks: int, block_size: int,
               sliding_window: Optional[int] = None) -> int:
    """B2's grid of splits a (sequence, kv head): as many as keep the pairs
    within _TARGET_BLOCKS blocks, and no more than the walk cap holds runs
    of ``min_split_slots``. The host fixes only this count; each block takes
    its span from its sequence's length on the device (``split_spans``)."""
    walk = walk_slots(max_blocks, block_size, sliding_window)
    most = max(1, walk // min_split_slots(block_size))
    return max(1, min(most, _TARGET_BLOCKS // (batch * num_kv_heads)))


def split_spans(seq_len: int, splits: int, max_blocks: int, block_size: int,
                sliding_window: Optional[int] = None) -> list[tuple[int, int]]:
    """Host model of each split's table slots [t0, t1) (of the walk from the
    first in-window slot), as ``csrc/paged_attention.cu`` derives them on the
    device from ``seq_len``: the sequence's walk of
    ``min(walk cap, ceil(seq_len/BS) - lo)`` slots in ``used`` floor-balanced
    runs, ``used = max(1, min(splits, walk // min_split_slots))``; the
    splits past ``used`` are empty."""
    lo = max(seq_len - sliding_window, 0) // block_size if sliding_window else 0
    cap = walk_slots(max_blocks, block_size, sliding_window)
    walk = max(0, min(cap, -(-seq_len // block_size) - lo))
    used = max(1, min(splits, walk // min_split_slots(block_size)))
    return [(z * walk // used, (z + 1) * walk // used) if z < used else (walk, walk)
            for z in range(splits)]


def paged_attention_reference(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor, block_tables: torch.Tensor,
                              seq_lens: torch.Tensor, *, block_size: int,
                              k_scale: Optional[torch.Tensor] = None,
                              v_scale: Optional[torch.Tensor] = None,
                              sliding_window: Optional[int] = None,
                              logit_softcap: Optional[float] = None,
                              alibi: Optional[torch.Tensor] = None,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of B2: dense gather of every table slot, float32
    softmax (``blazr_tpu/attention/paged_attention.py:344`` plus the int8
    KV scales, applied as ``models/layers.attend`` applies them). ``scale``
    multiplies q·k (default ``1/sqrt(D)``)."""
    b, h_q, d = q.shape
    h_kv = k_cache.shape[1]
    mb = block_tables.shape[1]
    idx = page_slot_index(block_size, block_tables)              # [B, S]
    n_rep = h_q // h_kv
    k = k_cache[idx].to(torch.float32).repeat_interleave(n_rep, dim=2)
    v = v_cache[idx].to(torch.float32).repeat_interleave(n_rep, dim=2)
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    logits = torch.einsum("bhd,bshd->bhs", q.to(torch.float32) * scale, k)
    if k_scale is not None:
        ks = k_scale[idx].repeat_interleave(n_rep, dim=2)         # [B, S, H_q]
        logits = logits * ks.permute(0, 2, 1)
    if logit_softcap is not None:
        logits = torch.tanh(logits / logit_softcap) * logit_softcap
    kv_pos = torch.arange(mb * block_size, dtype=torch.int32,
                          device=q.device)[None, :]
    sl = seq_lens.to(torch.int32)[:, None]
    if alibi is not None:
        rel = (kv_pos - (sl - 1)).to(torch.float32)
        logits = logits + alibi.to(torch.float32)[None, :, None] * rel[:, None, :]
    mask = kv_pos < sl
    if sliding_window is not None:
        mask = mask & (kv_pos > sl - 1 - sliding_window)
    logits = torch.where(mask[:, None, :], logits,
                         torch.full_like(logits, -1e30))
    p = torch.softmax(logits, dim=-1)
    if v_scale is not None:
        vsc = v_scale[idx].repeat_interleave(n_rep, dim=2)
        p = p * vsc.permute(0, 2, 1)
    return torch.einsum("bhs,bshd->bhd", p, v).to(q.dtype)


def paged_attention_decode(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, block_tables: torch.Tensor,
                           seq_lens: torch.Tensor, *, block_size: int,
                           num_blocks: int,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           sliding_window: Optional[int] = None,
                           logit_softcap: Optional[float] = None,
                           alibi: Optional[torch.Tensor] = None,
                           scale: Optional[float] = None,
                           device: DeviceLike = None) -> torch.Tensor:
    """Decode attention over block-table pages on ``device`` (default
    ``cuda``); every tensor must lie there. ``scale`` multiplies q·k before
    the softcap (default ``1/sqrt(D)``; Gemma2 gives
    ``query_pre_attn_scalar ** -0.5``)."""
    dev = resolve_device(device)
    check_on(dev, q, k_cache, v_cache, block_tables, seq_lens, k_scale,
             v_scale, alibi)
    if q.dim() != 3 or k_cache.dim() != 3 or k_cache.shape != v_cache.shape:
        raise ValueError("q must be [B, H_q, D] and the caches [slots, H_kv, D]")
    b, h_q, d = q.shape
    slots, h_kv, dk = k_cache.shape
    if dk != d or h_q % h_kv:
        raise ValueError(f"q {tuple(q.shape)} does not fit cache {tuple(k_cache.shape)}")
    if slots < num_blocks * block_size:
        raise ValueError(f"cache has {slots} slots < {num_blocks}x{block_size}")
    if block_tables.dim() != 2 or block_tables.shape[0] != b or seq_lens.shape != (b,):
        raise ValueError("block_tables must be [B, MB] and seq_lens [B]")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("int8 KV needs both k_scale and v_scale")
    if dev.type == "cpu":
        return paged_attention_reference(
            q, k_cache, v_cache, block_tables, seq_lens, block_size=block_size,
            k_scale=k_scale, v_scale=v_scale, sliding_window=sliding_window,
            logit_softcap=logit_softcap, alibi=alibi, scale=scale)

    quantized = k_scale is not None
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"B2 takes bfloat16, float32 or float16 queries, got {q.dtype}")
    if quantized:
        if k_cache.dtype != torch.int8 or k_scale.dtype != torch.float32:
            raise TypeError("int8 KV needs int8 caches and float32 scales")
    elif k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"cache dtype {k_cache.dtype} must match q {q.dtype}")
    if d % 32 or d > 256:
        raise ValueError(f"B2 takes head_dim a multiple of 32 up to 256, got {d}")
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("block_tables and seq_lens must be int32")
    tensors = [q, k_cache, v_cache, block_tables, seq_lens, k_scale, v_scale]
    if alibi is not None:
        alibi = alibi.to(torch.float32).contiguous()
    if not all(t is None or t.is_contiguous() for t in tensors):
        raise ValueError("B2 needs contiguous operands")
    out = torch.empty_like(q)
    if b == 0:
        return out
    mb = block_tables.shape[1]
    splits = split_plan(b, h_kv, mb, block_size, sliding_window)
    part_acc = part_ml = None
    if splits > 1:
        part_acc = torch.empty((b, h_q, splits, d), dtype=torch.float32, device=dev)
        part_ml = torch.empty((b, h_q, splits, 2), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _lib().pa_decode_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), ptr(k_scale),
        ptr(v_scale), block_tables.data_ptr(), seq_lens.data_ptr(), ptr(alibi),
        out.data_ptr(), ptr(part_acc), ptr(part_ml), b, h_q, h_kv, d, block_size,
        num_blocks, mb, int(sliding_window or 0), float(logit_softcap or 0.0),
        1.0 / math.sqrt(d) if scale is None else float(scale), splits,
        min_split_slots(block_size), _DTYPE_CODE[q.dtype],
        int(quantized),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"paged attention launch failed with CUDA error {err}")
    paged_attention_decode.launches += 1
    return out


paged_attention_decode.launches = 0
