"""Paged KV memory: page allocator, request page table, device KV cache.

Copies of ``PageAllocator`` and ``ReqToPagePool`` from
semi_pd_tpu/mem/pool.py (numpy, host side, single owner: the scheduler),
trimmed to one partition (DP-attention partitions are ROADMAP A15), plus a
torch ``KVCache`` holding one of the JAX package's three pool layouts
(``KVCacheSpec.layout``):

- chunked ``[L, S, CT, 128]``: ``CT = 2 * Hkv * D / 128`` chunks per slot
  row, K chunks first, then V chunks (the JAX ``KVCache(chunked=True)``
  layout; the runner picks it for head_dim 64 models with CT % 8 == 0);
- aligned ``[L, 2, S, Hkv, D]``: K and V each in their own plane (the JAX
  default layout; head_dim 128 models, and head_dim 64 models with CT % 8
  != 0);
- latent ``[L, 1, S, 1, Dlat]``: one MLA latent row ``[c_kv | k_pe]`` per
  slot, V being its first ``kv_lora_rank`` elements (the JAX
  ``use_mla=True`` layout). The JAX runner pads Dlat to a multiple of 256
  for Mosaic's lane tiling (576 -> 768); the port stores exactly Dlat.

Each layout holds bf16, float32 or fp8 (e4m3, e5m2) elements.

``S = num_pages * page_size`` slots; slot = page_id * page_size + offset.
Page 0 is the dump page: padded positions of a batch write there and padded
page-table entries point there.
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
    # "chunked" [L, S, CT, 128] (K chunks then V chunks per slot row; the
    # pool needs whole chunks, (2*Hkv*D) % 128 == 0, and the runner picks it
    # only at CT % 8 == 0), "aligned" [L, 2, S, Hkv, D] (the 5D pool) or
    # "latent" [L, 1, S, 1, D] (MLA, Hkv 1). Set by the runner's layout rule
    # (runtime/model_runner.py::kv_pool_layout).
    layout: str = "aligned"

    @property
    def num_slots(self) -> int:
        return self.num_pages * self.page_size

    @property
    def chunks_total(self) -> int:
        return 2 * self.num_kv_heads * self.head_dim // 128

    @property
    def num_components(self) -> int:
        """K and V, or the one latent row of MLA."""
        return 1 if self.layout == "latent" else 2

    def bytes_total(self) -> int:
        return (self.num_components * self.num_layers * self.num_slots
                * self.num_kv_heads * self.head_dim * self.dtype.itemsize)


class KVCache:
    """The pool (chunked, aligned or latent, per ``spec.layout``) as one
    device tensor, updated in place by ``layers.attention.paged_attention``
    (``paged_attention_mla`` for the latent pool).

    Allocated with ``torch.zeros``: page 0 (the dump page) is read by padded
    batch rows and must stay finite."""

    def __init__(self, spec: KVCacheSpec, device: torch.device):
        if spec.layout == "chunked":
            if (2 * spec.num_kv_heads * spec.head_dim) % 128:
                raise ValueError(
                    f"chunked KV pool needs whole 128-wide chunks, (2*Hkv*D) % 128 == 0 "
                    f"(Hkv={spec.num_kv_heads}, D={spec.head_dim})")
            shape = (spec.num_layers, spec.num_slots, spec.chunks_total, 128)
        elif spec.layout in ("aligned", "latent"):
            if spec.layout == "latent" and spec.num_kv_heads != 1:
                raise ValueError("the latent (MLA) pool holds one latent head")
            shape = (spec.num_layers, spec.num_components, spec.num_slots,
                     spec.num_kv_heads, spec.head_dim)
        else:
            raise ValueError(f"unknown KV pool layout {spec.layout!r}")
        self.spec = spec
        self.buffer = torch.zeros(shape, dtype=spec.dtype, device=device)
