"""Two-tier prefix cache: device blocks + host-RAM KV swap.

Counterpart of ``blazr_tpu/kvcache/host_tier.py`` (the reference
``GpuPrefixCache``: device→RAM two-tier, config ``gpu_prefix_cache`` +
``prefix_cache_ram_tier``). When a computed cached block is evicted from
the device pool, its K/V (and, in int8 mode, its scale planes; and a
speculative draft model's planes of the same block, whose paged cache shares
the target's block ids) are copied to host RAM keyed by the chain hash; a later lookup that misses on the
device restores them into the freshly allocated block instead of
recomputing its prefill.

Unlike the JAX tier, which rebinds the cache's arrays on restore, the
restore here writes IN PLACE into the slots of the existing tensors
(``cache.k[:, block slots].copy_(...)``): the decode steps are CUDA graphs
that hold the cache's storage, so the tensors must never be replaced.

The tier's memory is a pool of ``max_blocks`` slots per plane (at most
``MAX_BYTES`` in all), allocated once when the tier is attached (pinned on
CUDA) and reused in LRU order, so no save allocates or pins. On CUDA both copies are asynchronous and ordered
on the current stream, the one every prefill and decode round of the engine
runs on: a save (block -> a free slot) runs after the prefill that wrote the
block and before any later write to the block's next owner; a restore (slot
-> block) runs after the save it reads and after any stray write of the
block's previous owner. A slot freed by a restore or an LRU drop is written
again only by a later save, queued after the copy that read it. The host
never waits for a copy and never touches the pool.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from .paged import PagedKVCache
from .prefix_cache import PrefixCache, chain_hash

# The most memory a tier's pool takes (pinned on CUDA): 512 blocks of
# Mistral-7B's 8 MiB, where the default 5,000 blocks would pin 40 GiB.
MAX_BYTES = 4 << 30


@dataclass
class HostTierStats:
    saved: int = 0
    restored: int = 0
    dropped: int = 0
    # Host seconds spent queuing the copies (the copies themselves run on
    # the device's stream).
    save_s: float = 0.0
    restore_s: float = 0.0


class HostKVTier:
    """LRU store of evicted KV block contents: hash -> a slot of the pool,
    which holds ``max_blocks`` copies of one block of every plane
    ([L, BS, H, D] k and v, plus the two [L, BS, H] scale planes in int8
    mode)."""

    def __init__(self, max_blocks: int, block_planes: Sequence[torch.Tensor]):
        """``block_planes``: one block's slice of each cache plane; the pool
        is pinned when they lie on CUDA."""
        self.max_blocks = max_blocks
        self._pool = [torch.empty((max_blocks, *p.shape), dtype=p.dtype,
                                  pin_memory=p.is_cuda) for p in block_planes]
        self._free = list(range(max_blocks - 1, -1, -1))
        self._store: "OrderedDict[bytes, int]" = OrderedDict()
        self.stats = HostTierStats()

    @property
    def pool_bytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self._pool)

    def save(self, h: bytes, *arrays: torch.Tensor) -> None:
        """Copy one block's planes (k, v; + k_scale, v_scale for int8) into
        a free slot, dropping the least recently saved entry when full."""
        if h in self._store:
            self._store.move_to_end(h)
            return
        while len(self._store) >= self.max_blocks:
            self._free.append(self._store.popitem(last=False)[1])
            self.stats.dropped += 1
        slot = self._free.pop()
        for dst, src in zip(self._pool, arrays):
            dst[slot].copy_(src, non_blocking=src.is_cuda)
        self._store[h] = slot
        self.stats.saved += 1

    def take(self, h: bytes) -> Optional[tuple[torch.Tensor, ...]]:
        """The entry's planes (views of its slot, which is free again: read
        them before the next save), or None."""
        slot = self._store.pop(h, None)
        if slot is None:
            return None
        self._free.append(slot)
        self.stats.restored += 1
        return tuple(p[slot] for p in self._pool)

    def clear(self) -> None:
        """Drop every entry; their slots are free again."""
        self._free.extend(self._store.values())
        self._store.clear()

    def __contains__(self, h: bytes) -> bool:
        return h in self._store

    def __len__(self) -> int:
        return len(self._store)


def block_planes(cache: PagedKVCache, blk: int,
                 draft_cache: Optional[PagedKVCache] = None) -> list[torch.Tensor]:
    """Block ``blk``'s slots of every cache plane (views; slot axis 1), then
    those of ``draft_cache``'s."""
    bs = cache.block_size
    planes = [cache.k, cache.v]
    if cache.quantized:
        planes += [cache.k_scale, cache.v_scale]
    out = [p[:, blk * bs:(blk + 1) * bs] for p in planes]
    return out if draft_cache is None else out + block_planes(draft_cache, blk)


def restore_block(cache: PagedKVCache, blk: int, item: tuple[torch.Tensor, ...],
                  draft_cache: Optional[PagedKVCache] = None) -> None:
    """Write a saved block's contents into block ``blk``'s slots of the
    existing cache tensors, in place. A float block carries 2 planes; an
    int8 block 4 (the scales travel with it); a draft cache's follow."""
    for dst, src in zip(block_planes(cache, blk, draft_cache), item):
        dst.copy_(src, non_blocking=dst.is_cuda)


def attach_host_tier(prefix_cache: PrefixCache, cache: PagedKVCache,
                     max_blocks: int = 5000,
                     max_bytes: int = MAX_BYTES,
                     draft_cache: Optional[PagedKVCache] = None) -> HostKVTier:
    """Wire a HostKVTier of ``max_blocks`` slots (fewer if they would take
    more than ``max_bytes``; at least one) into a PrefixCache and the
    PagedKVCache whose tensors it serves (never replaced: restores write
    into them). A draft model's cache over the same block ids
    (``draft_cache``) is saved and restored with it, so a restored block's
    draft K/V is its own.

    * On eviction of a computed block: its KV slots are copied host-side.
    * After a lookup: blocks past the device tier's hits whose hash is in
      the host tier are restored into the blocks the lookup allocated, in
      order until the first one the tier lacks, adopted by the prefix cache
      (registered, computed), and their tokens counted as cached (a
      whole-prompt hit is capped at ``len(tokens) - 1``: its last token's
      logits are needed).
    """
    planes = block_planes(cache, 0, draft_cache)
    block_bytes = sum(p.numel() * p.element_size() for p in planes)
    tier = HostKVTier(max(1, min(max_blocks, max_bytes // block_bytes)), planes)

    def on_evict(h: bytes, blk: int) -> None:
        t0 = time.perf_counter()
        tier.save(h, *block_planes(cache, blk, draft_cache))
        tier.stats.save_s += time.perf_counter() - t0

    def on_lookup(seq_id: int, tokens: list[int], cached: int, blocks: list[int]) -> int:
        bs = prefix_cache.block_size
        prev = b"root"
        for i in range(len(blocks)):
            chunk = tuple(tokens[i * bs:(i + 1) * bs])
            if len(chunk) < bs:
                break
            h = chain_hash(prev, chunk)
            if i * bs >= cached:
                item = tier.take(h)
                if item is None:
                    break
                t0 = time.perf_counter()
                restore_block(cache, blocks[i], item, draft_cache)
                tier.stats.restore_s += time.perf_counter() - t0
                prefix_cache.adopt(seq_id, h, blocks[i], i)
                cached = (i + 1) * bs
            prev = h
        if cached >= len(tokens):
            cached = len(tokens) - 1
        return cached

    prefix_cache.on_evict = on_evict
    prefix_cache.on_lookup = on_lookup
    prefix_cache.host_tier = tier
    return tier
