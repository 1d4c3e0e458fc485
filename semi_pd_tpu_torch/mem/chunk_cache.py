"""No-reuse prefix cache stub (reference: srt/mem_cache/chunk_cache.py:1-65,
the cache used when radix is disabled). Same interface as RadixCache but
never shares pages; match_prefix always misses."""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np

from semi_pd_tpu_torch.mem.radix_cache import TreeNode


class ChunkCache:
    def __init__(self, page_size: int, free_pages_fn: Callable[[np.ndarray], None]):
        self.page_size = page_size
        self.free_pages_fn = free_pages_fn
        self.root = TreeNode()
        self.evictable_pages = 0
        self.protected_pages = 0
        self.version = 0  # never bumped: match_prefix always misses

    def reset(self):
        pass

    def match_prefix(self, token_ids: List[int]) -> Tuple[np.ndarray, TreeNode]:
        return np.empty((0,), dtype=np.int32), self.root

    def insert(self, token_ids: List[int], pages: np.ndarray) -> Tuple[int, TreeNode]:
        # Nothing retained: caller keeps ownership and frees pages itself.
        return -1, self.root

    def inc_lock_ref(self, node: TreeNode):
        pass

    def dec_lock_ref(self, node: TreeNode):
        pass

    def evict(self, num_pages: int) -> int:
        return 0

    def total_cached_pages(self) -> int:
        return 0
