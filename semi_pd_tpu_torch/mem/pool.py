"""Paged KV memory: page allocator, request page table, device KV cache.

Copies of ``PageAllocator`` and ``ReqToPagePool`` from
semi_pd_tpu/mem/pool.py (numpy, host side, single owner: the scheduler),
trimmed to one partition (DP-attention partitions are ROADMAP A15), plus a
torch ``KVCache`` holding the chunked combined pool the main path uses.

Layout: ``[L, S, CT, 128]`` with ``S = num_pages * page_size`` slots and
``CT = 2 * Hkv * D / 128`` chunks per slot row, K chunks first, then V
chunks (the JAX ``KVCache(chunked=True)`` layout). Slot = page_id *
page_size + offset. Page 0 is the dump page: padded positions of a batch
write there and padded page-table entries point there.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import List, Optional

import numpy as np
import torch


class PageAllocator:
    """Freelist allocator over KV pages. The free list is a min-heap (lowest
    page first), so freed ranges re-coalesce and multi-page allocations keep
    landing as consecutive runs."""

    def __init__(self, num_pages: int, page_size: int):
        self.num_pages = num_pages
        self.page_size = page_size
        # page 0 is reserved as the dump page; an ascending range is already
        # a valid min-heap
        self._free: List[int] = list(range(1, num_pages))

    @property
    def usable_pages(self) -> int:
        return self.num_pages - 1

    def available_pages(self) -> int:
        return len(self._free)

    def alloc(self, n_pages: int) -> Optional[np.ndarray]:
        if n_pages > len(self._free):
            return None
        if n_pages == 0:
            return np.empty((0,), dtype=np.int32)
        return np.array(
            [heapq.heappop(self._free) for _ in range(n_pages)], dtype=np.int32
        )

    def free(self, pages) -> None:
        for p in pages.tolist() if isinstance(pages, np.ndarray) else pages:
            p = int(p)
            if p != 0:  # the dump page is never freed
                heapq.heappush(self._free, p)


class ReqToPagePool:
    """Request-slot pool + host page table: ``page_table[slot, j]`` is the
    page backing tokens ``[j*page_size, (j+1)*page_size)`` of that request.
    The authoritative copy is host numpy; per-batch slices travel with each
    step."""

    def __init__(self, max_reqs: int, max_context_len: int, page_size: int):
        self.max_reqs = max_reqs
        self.page_size = page_size
        self.max_pages_per_req = (max_context_len + page_size - 1) // page_size
        self.page_table = np.zeros(
            (max_reqs, self.max_pages_per_req), dtype=np.int32
        )
        self.free_slots: List[int] = list(range(max_reqs - 1, -1, -1))

    def available_slots(self) -> int:
        return len(self.free_slots)

    def alloc(self) -> Optional[int]:
        if not self.free_slots:
            return None
        return self.free_slots.pop()

    def free(self, slot: int) -> None:
        self.page_table[slot, :] = 0
        self.free_slots.append(slot)

    def write(self, slot: int, start_page: int, pages: np.ndarray) -> None:
        self.page_table[slot, start_page : start_page + len(pages)] = pages


@dataclasses.dataclass
class KVCacheSpec:
    num_layers: int
    num_pages: int
    page_size: int
    num_kv_heads: int
    head_dim: int
    dtype: torch.dtype = torch.bfloat16

    @property
    def num_slots(self) -> int:
        return self.num_pages * self.page_size

    @property
    def chunks_total(self) -> int:
        return 2 * self.num_kv_heads * self.head_dim // 128

    def bytes_total(self) -> int:
        per = torch.tensor([], dtype=self.dtype).element_size()
        return 2 * self.num_layers * self.num_slots * self.num_kv_heads * self.head_dim * per


class KVCache:
    """The chunked combined pool ``[L, S, CT, 128]`` as one device tensor,
    updated in place by ``layers.attention.paged_attention``.

    Allocated with ``torch.zeros``: page 0 (the dump page) is read by padded
    batch rows and must stay finite."""

    def __init__(self, spec: KVCacheSpec, device: torch.device):
        if (2 * spec.num_kv_heads * spec.head_dim) % 128 or 128 % spec.head_dim:
            raise NotImplementedError(
                f"chunked KV pool needs 128 % head_dim == 0 and "
                f"(2*Hkv*D) % 128 == 0 (Hkv={spec.num_kv_heads}, "
                f"D={spec.head_dim}); the aligned 5D pool is ROADMAP A9")
        self.spec = spec
        self.buffer = torch.zeros(
            (spec.num_layers, spec.num_slots, spec.chunks_total, 128),
            dtype=spec.dtype, device=device,
        )
