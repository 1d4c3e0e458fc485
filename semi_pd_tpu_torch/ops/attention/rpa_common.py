"""Shared helpers of the port's ragged paged attention wrappers: argument
checks before a pointer reaches a kernel, the per-layer pool pointer, and
the page gather the plain versions use."""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

# argtypes pieces of the C entry points
P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

# head_dim the kernels are instantiated for: the main path's
KERNEL_HEAD_DIM = 64


def check_pool_args(q, kv_cache, layer_idx, page_table, kv_lens, num_kv_heads,
                    head_dim) -> Tuple[int, int, int]:
    """Validate what every wrapper passes on; returns (Hq, D, G)."""
    if q.dim() != 3:
        raise ValueError(f"q must be [rows, Hq, D], got {tuple(q.shape)}")
    _, Hq, D = q.shape
    if D != head_dim:
        raise ValueError(f"q head_dim {D} != head_dim {head_dim}")
    if num_kv_heads <= 0 or Hq % num_kv_heads:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={num_kv_heads}")
    if kv_cache.dim() != 4 or kv_cache.shape[3] != 128:
        raise ValueError(f"kv_cache must be the chunked pool [L, S, CT, 128], "
                         f"got {tuple(kv_cache.shape)}")
    if kv_cache.shape[2] * 128 != 2 * num_kv_heads * D:
        raise ValueError(f"pool rows hold {kv_cache.shape[2] * 128} elements, "
                         f"expected 2*Hkv*D = {2 * num_kv_heads * D}")
    if not 0 <= int(layer_idx) < kv_cache.shape[0]:
        raise ValueError(f"layer {layer_idx} outside the pool's {kv_cache.shape[0]} layers")
    if kv_cache.dtype != q.dtype:
        raise ValueError(f"q dtype {q.dtype} != KV dtype {kv_cache.dtype} "
                         f"(fp8 KV is ROADMAP A9)")
    if page_table.dtype != torch.int32 or kv_lens.dtype != torch.int32:
        raise ValueError("page_table and kv_lens must be int32")
    if page_table.dim() != 2 or kv_lens.shape != (page_table.shape[0],):
        raise ValueError(f"page_table [B, maxP] and kv_lens [B] disagree: "
                         f"{tuple(page_table.shape)} vs {tuple(kv_lens.shape)}")
    return Hq, D, Hq // num_kv_heads


def check_cuda(*tensors) -> None:
    """Everything a kernel reads or writes: one CUDA device, contiguous, a
    dtype the kernels were built for, and 16-byte aligned where the kernel
    reads 16-byte vectors (q, the pool). The int32 arrays are read element
    by element and may be views into the packed step vector."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
        if t.is_floating_point() and t.data_ptr() % 16:
            raise ValueError("q and the KV pool must be 16-byte aligned")
    if tensors[0].dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"kernels take bfloat16 or float32, got {tensors[0].dtype}")
    if tensors[0].shape[-1] != KERNEL_HEAD_DIM:
        raise NotImplementedError(
            f"head_dim {tensors[0].shape[-1]}: the kernels are built for "
            f"{KERNEL_HEAD_DIM} only; other head dims are ROADMAP A9")


def layer_ptr(kv_cache: torch.Tensor, layer_idx: int) -> int:
    """Address of layer ``layer_idx`` of the pool (computed in Python ints:
    a full pool can exceed 2**31 elements)."""
    L, S, CT, W = kv_cache.shape
    return kv_cache.data_ptr() + int(layer_idx) * S * CT * W * kv_cache.element_size()


def gather_kv(kv5: torch.Tensor, pt_row: torch.Tensor, n: int, page_size: int):
    """K and V of positions [0, n) of one request, as float32 [n, Hkv, D],
    read page by page through the request's page-table row. ``kv5`` is the
    layer's pool viewed as [S, 2, Hkv, D]."""
    pos = torch.arange(n, device=kv5.device)
    slots = pt_row.long()[pos // page_size] * page_size + pos % page_size
    rows = kv5[slots]
    return rows[:, 0].float(), rows[:, 1].float()


def layer_kv5(kv_cache: torch.Tensor, layer_idx: int, num_kv_heads: int, head_dim: int):
    S = kv_cache.shape[1]
    return kv_cache[int(layer_idx)].reshape(S, 2, num_kv_heads, head_dim)
