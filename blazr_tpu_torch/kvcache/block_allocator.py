"""Block allocator for the paged KV cache.

Copy of ``blazr_tpu/kvcache/block_allocator.py``, the counterpart of boostr ``inference::memory::CpuBlockAllocator``
(SURVEY §2.9 "Block memory" row): host-side free-list + refcount
management over device KV blocks. Refcounts enable copy-on-write style
prefix sharing (prefix cache holds extra refs).
"""

from __future__ import annotations

from dataclasses import dataclass

BlockId = int


@dataclass
class BlockAllocatorStats:
    total_blocks: int
    free_blocks: int
    allocated_blocks: int

    @property
    def utilization(self) -> float:
        if self.total_blocks == 0:
            return 0.0
        return self.allocated_blocks / self.total_blocks


class BlockAllocator:
    """Free-list allocator with per-block refcounts."""

    def __init__(self, num_blocks: int, block_size: int):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: list[BlockId] = list(range(num_blocks - 1, -1, -1))
        self._refs: dict[BlockId, int] = {}

    # -- allocation --------------------------------------------------------
    def allocate(self, n: int = 1) -> list[BlockId]:
        if n > len(self._free):
            raise MemoryError(
                f"KV block pool exhausted: need {n}, free {len(self._free)}")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._refs[b] = 1
        return out

    def can_allocate(self, n: int) -> bool:
        return n <= len(self._free)

    def inc_ref(self, block: BlockId) -> None:
        self._refs[block] = self._refs.get(block, 0) + 1

    def free(self, blocks: list[BlockId]) -> None:
        """Drop one reference per block; blocks return to the pool at 0."""
        for b in blocks:
            r = self._refs.get(b, 0) - 1
            if r <= 0:
                self._refs.pop(b, None)
                self._free.append(b)
            else:
                self._refs[b] = r

    def ref_count(self, block: BlockId) -> int:
        return self._refs.get(block, 0)

    # -- introspection -----------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def stats(self) -> BlockAllocatorStats:
        return BlockAllocatorStats(
            total_blocks=self.num_blocks,
            free_blocks=len(self._free),
            allocated_blocks=self.num_blocks - len(self._free),
        )


def blocks_needed(num_tokens: int, block_size: int) -> int:
    """Reference BlockTable::blocks_needed."""
    return (num_tokens + block_size - 1) // block_size
