"""Prefix cache over the paged-KV block table.

Copy of ``blazr_tpu/kvcache/prefix_cache.py`` (boostr
``inference::prefix_cache::PrefixCache``): full blocks of prompt tokens are
hashed (chained blake2b, so a block's identity includes its prefix) and
shared across sequences through allocator refcounts.
``get_or_allocate_blocks`` returns how many leading tokens are already
cached; prefill then runs only on the uncached suffix. Host-only code.

The JAX host tier wraps ``_evict_one`` and ``get_or_allocate_blocks`` of
the instance; here the two calls take hooks instead (``on_evict``,
``on_lookup``, set by ``host_tier.attach_host_tier``), with the same
semantics: a computed block is saved just before it is evicted, and a
lookup may restore deeper blocks after the device tier's hits.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Callable, Optional

from .block_allocator import BlockAllocator, BlockId, blocks_needed


@dataclass
class PrefixCacheStats:
    hits: int = 0
    misses: int = 0
    cached_blocks: int = 0
    evictions: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


@dataclass
class PrefixCacheConfig:
    max_cached_blocks: int = 10000


def chain_hash(prev: bytes, tokens: tuple[int, ...]) -> bytes:
    h = hashlib.blake2b(prev, digest_size=16)
    for t in tokens:
        h.update(t.to_bytes(4, "little", signed=True))
    return h.digest()


class PrefixCache:
    """Chained block-hash → block-id cache with LRU eviction."""

    def __init__(self, allocator: BlockAllocator,
                 config: Optional[PrefixCacheConfig] = None):
        self.allocator = allocator
        self.config = config or PrefixCacheConfig()
        self.block_size = allocator.block_size
        self._by_hash: dict[bytes, BlockId] = {}
        self._hash_of: dict[BlockId, bytes] = {}
        self._lru: dict[bytes, int] = {}
        self._clock = 0
        self._seq_blocks: dict[int, list[BlockId]] = {}
        # Blocks whose KV has actually been written by a prefill. A block is
        # only served as a hit once computed — otherwise a request aborted
        # between admission and prefill would leave garbage KV registered
        # and a retry of the same prompt would silently skip prefill over it.
        self._computed: set[BlockId] = set()
        # seq_id -> [(block, hash, end_token_index)] registered by that
        # sequence but not yet covered by a completed prefill.
        self._pending: dict[int, list[tuple[BlockId, bytes, int]]] = {}
        self.stats = PrefixCacheStats()
        # Host-tier hooks: on_evict(hash, block) before a computed block is
        # evicted; on_lookup(seq_id, tokens, cached, blocks) -> cached after
        # every lookup.
        self.on_evict: Optional[Callable[[bytes, BlockId], None]] = None
        self.on_lookup: Optional[Callable[[int, list[int], int, list[BlockId]], int]] = None
        self.host_tier = None

    # ------------------------------------------------------------------
    def get_or_allocate_blocks(self, seq_id: int, tokens: list[int],
                               ) -> tuple[int, list[BlockId]]:
        """Returns (cached_token_count, full block list for the prompt).

        Cached blocks get an extra ref (shared); uncached blocks are fresh
        allocations registered under their chain hash.
        """
        bs = self.block_size
        n_blocks = blocks_needed(len(tokens), bs)
        blocks: list[BlockId] = []
        cached_tokens = 0
        prev = b"root"
        reused = True
        self._clock += 1
        pending = self._pending.setdefault(seq_id, [])
        pending_start = len(pending)
        try:
            for i in range(n_blocks):
                chunk = tuple(tokens[i * bs : (i + 1) * bs])
                full = len(chunk) == bs
                if full:
                    h = chain_hash(prev, chunk)
                    hit = self._by_hash.get(h)
                    if reused and hit is not None and hit in self._computed:
                        self.allocator.inc_ref(hit)
                        blocks.append(hit)
                        cached_tokens += bs
                        self._lru[h] = self._clock
                        self.stats.hits += 1
                        prev = h
                        continue
                    if reused:
                        self.stats.misses += 1
                    reused = False
                    blk = self._fresh_block()
                    if h not in self._by_hash:
                        # Register the hash now (so concurrent identical
                        # prompts dedupe) but serve hits only after
                        # mark_computed.
                        self._register(h, blk)
                        pending.append((blk, h, (i + 1) * bs))
                    blocks.append(blk)
                    prev = h
                else:
                    blocks.append(self._fresh_block())
        except MemoryError:
            # Exception safety: blocks allocated/registered before the
            # failure would otherwise leak with the cache's extra ref and
            # become permanently unevictable (ref_count stuck at 2).
            for blk, h, _ in pending[pending_start:]:
                if self._by_hash.get(h) == blk:
                    self._by_hash.pop(h, None)
                    self._hash_of.pop(blk, None)
                    self._lru.pop(h, None)
                    self.stats.cached_blocks -= 1
                    self.allocator.free([blk])     # the cache's own ref
            del pending[pending_start:]
            if not pending:
                self._pending.pop(seq_id, None)
            for b in blocks:
                self.allocator.free([b])
            raise
        # A copy: the caller keeps ``blocks`` as its block table and extends
        # it with what ``extend`` returns, which ``extend`` also records
        # here. One shared list would hold each decode block twice and free
        # it twice (the JAX package's prefix_cache.py:132 shares it; ROADMAP
        # §C), so two later sequences would be handed the same block.
        self._seq_blocks[seq_id] = list(blocks)
        if self.on_lookup is not None:
            cached_tokens = self.on_lookup(seq_id, tokens, cached_tokens, blocks)
        return cached_tokens, blocks

    def mark_computed(self, seq_id: int, prefilled_tokens: int) -> None:
        """Expose this sequence's registered blocks covered by a completed
        prefill as reusable (reference/vLLM semantics: only computed blocks
        serve cache hits)."""
        pending = self._pending.get(seq_id)
        if not pending:
            return
        keep = []
        for blk, h, end in pending:
            if end <= prefilled_tokens:
                self._computed.add(blk)
            else:
                keep.append((blk, h, end))
        if keep:
            self._pending[seq_id] = keep
        else:
            self._pending.pop(seq_id, None)

    def extend(self, seq_id: int, n_new_blocks: int) -> list[BlockId]:
        """Allocate decode-time blocks (not registered in the cache),
        evicting LRU cache-retained blocks under pressure — otherwise a
        warm cache full of evictable blocks would starve running decodes
        into preemption thrash."""
        new: list[BlockId] = []
        try:
            for _ in range(n_new_blocks):
                new.append(self._fresh_block())
        except MemoryError:
            self.allocator.free(new)
            raise
        self._seq_blocks.setdefault(seq_id, []).extend(new)
        return new

    def release_blocks(self, seq_id: int) -> None:
        """Drop this sequence's refs. Computed registered blocks stay alive
        — the cache holds its own reference until eviction (two-tier
        retention, so later requests reuse prefixes of finished ones).
        Blocks this sequence registered but never computed (aborted before
        prefill) are deregistered so their garbage KV can't be served."""
        for blk, h, _ in self._pending.pop(seq_id, []):
            if self._by_hash.get(h) == blk:
                self._by_hash.pop(h, None)
                self._hash_of.pop(blk, None)
                self._lru.pop(h, None)
                self.stats.cached_blocks -= 1
                self.allocator.free([blk])   # drop the cache's own ref
        for b in self._seq_blocks.pop(seq_id, []):
            self.allocator.free([b])
            if self.allocator.ref_count(b) == 0:
                self._computed.discard(b)
                # Unregistered (decode-time) block fully freed.
                h = self._hash_of.pop(b, None)
                if h is not None:
                    self._by_hash.pop(h, None)
                    self._lru.pop(h, None)
                    self.stats.cached_blocks -= 1

    def adopt(self, seq_id: int, h: bytes, blk: BlockId) -> None:
        """Serve ``blk`` of ``seq_id`` as the block of hash ``h`` now: its KV
        was written by other means than this sequence's prefill (a restore
        from the host tier). Registers it if the hash is free, marks it
        computed and drops it from the sequence's pending blocks."""
        if h not in self._by_hash:
            self._register(h, blk)
        self._computed.add(blk)
        pend = self._pending.get(seq_id)
        if pend:
            pend[:] = [p for p in pend if p[0] != blk]

    # ------------------------------------------------------------------
    def _fresh_block(self) -> BlockId:
        while not self.allocator.can_allocate(1):
            before = self.stats.evictions
            self._evict_one()
            if self.stats.evictions == before:
                break                        # nothing evictable
        return self.allocator.allocate(1)[0]

    def _register(self, h: bytes, blk: BlockId) -> None:
        if len(self._by_hash) >= self.config.max_cached_blocks:
            self._evict_one()
        self.allocator.inc_ref(blk)          # the cache's own reference
        self._by_hash[h] = blk
        self._hash_of[blk] = h
        self._lru[h] = self._clock
        self.stats.cached_blocks += 1

    def _evict_one(self) -> None:
        """Evict the least-recently-used cached block that nobody holds."""
        for h in sorted(self._lru, key=self._lru.get):  # type: ignore[arg-type]
            blk = self._by_hash.get(h)
            if blk is None:
                self._lru.pop(h, None)
                continue
            if self.allocator.ref_count(blk) <= 1:
                # Only computed blocks hold real KV worth preserving.
                if self.on_evict is not None and blk in self._computed:
                    self.on_evict(h, blk)
                self._by_hash.pop(h, None)
                self._hash_of.pop(blk, None)
                self._lru.pop(h, None)
                self._computed.discard(blk)
                self.allocator.free([blk])
                self.stats.cached_blocks -= 1
                self.stats.evictions += 1
                return
        # nothing evictable — allocator will raise if truly exhausted
