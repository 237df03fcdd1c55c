from .block_allocator import BlockAllocator, blocks_needed
from .contiguous import KVCache, init_kv_cache
from .paged import (PAD_BLOCK, PagedKVCache, compute_slot_mapping,
                    init_paged_cache, pad_block_table, write_paged_layer)

__all__ = ["BlockAllocator", "KVCache", "PAD_BLOCK", "PagedKVCache",
           "blocks_needed", "compute_slot_mapping", "init_kv_cache",
           "init_paged_cache", "pad_block_table", "write_paged_layer"]
