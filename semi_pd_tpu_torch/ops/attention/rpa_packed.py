"""Paged DECODE attention over the chunked combined pool: the CUDA kernel's
wrapper and its plain PyTorch version.

Port of semi_pd_tpu/ops/attention/rpa_packed.py::
ragged_paged_attention_chunked_packed (TPU kernel _rpa_kernel_chunked_packed,
rpa_packed.py:32). One query row per request at position kv_len - 1; GQA,
f32 online softmax, optional logit softcap and sliding window. The TPU
kernel's rpb/SUB request packing and its RPA_DECODE_PACKED /
RPA_PACKED_DIAG switches schedule work for the TPU and are not ported; the
CUDA design (csrc/rpa_decode.cu) is described there.

``ragged_paged_attention_chunked_packed`` launches the kernel for CUDA
tensors and uses ``..._plain`` only for tensors on the CPU; any other
device raises. Nothing falls back.
"""

from __future__ import annotations

from typing import Optional

import torch

from semi_pd_tpu_torch.kernels import CudaKernel, cuda_stream_ptr, register
from semi_pd_tpu_torch.ops.attention.rpa_common import (
    F, I, P, check_cuda, check_pool_args, gather_kv, layer_kv5, layer_ptr,
)

DECODE_KERNEL = register(CudaKernel(
    name="rpa_decode",
    source="csrc/rpa_decode.cu",
    symbol="rpa_decode",
    argtypes=[P, P, P, P, P, I, I, I, I, I, I, I, F, F, I, I, P],
    replaces="semi_pd_tpu/ops/attention/rpa_packed.py:32 _rpa_kernel_chunked_packed",
))


def ragged_paged_attention_chunked_packed(
    q: torch.Tensor,  # [B, Hq, D] one row per request
    kv_cache: torch.Tensor,  # [L, S, CT, 128]
    layer_idx: int,
    page_table: torch.Tensor,  # [B, maxP] int32
    kv_lens: torch.Tensor,  # [B] int32
    *,
    page_size: int,
    num_kv_heads: int,
    head_dim: int,
    scale: float,
    logit_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Decode attention: returns [B, Hq, D]; rows with kv_len == 0 are 0."""
    check_pool_args(q, kv_cache, layer_idx, page_table, kv_lens, num_kv_heads, head_dim)
    if q.shape[0] != page_table.shape[0]:
        raise ValueError("decode takes one query row per request (T == B)")
    if q.device.type == "cpu":
        return ragged_paged_attention_chunked_packed_plain(
            q, kv_cache, layer_idx, page_table, kv_lens, page_size=page_size,
            num_kv_heads=num_kv_heads, head_dim=head_dim, scale=scale,
            logit_cap=logit_cap, sliding_window=sliding_window)
    if q.device.type != "cuda":
        raise RuntimeError(f"no decode kernel for device {q.device}")
    check_cuda(q, kv_cache, page_table, kv_lens)
    B, Hq, D = q.shape
    out = torch.empty_like(q)
    DECODE_KERNEL.launch(
        q.data_ptr(), layer_ptr(kv_cache, layer_idx), page_table.data_ptr(),
        kv_lens.data_ptr(), out.data_ptr(), B, Hq, num_kv_heads, D,
        kv_cache.shape[2] * 128, page_table.shape[1], page_size, float(scale),
        float(logit_cap or 0.0), int(sliding_window or 0),
        int(q.dtype == torch.bfloat16), cuda_stream_ptr(q.device))
    return out


def ragged_paged_attention_chunked_packed_plain(
    q, kv_cache, layer_idx, page_table, kv_lens, *, page_size, num_kv_heads,
    head_dim, scale, logit_cap=None, sliding_window=None,
) -> torch.Tensor:
    """Plain version of the decode kernel: a loop over requests, each
    gathering its pages, then a full float32 softmax."""
    B, Hq, D = q.shape
    Hkv = num_kv_heads
    G = Hq // Hkv
    kv5 = layer_kv5(kv_cache, layer_idx, Hkv, D)
    lens = kv_lens.tolist()
    cap = page_table.shape[1] * page_size
    out = torch.zeros_like(q)
    for b in range(B):
        n = min(lens[b], cap)
        if n <= 0:
            continue
        k, v = gather_kv(kv5, page_table[b], n, page_size)
        s = torch.einsum("hgd,nhd->hgn", q[b].float().reshape(Hkv, G, D), k) * scale
        if logit_cap:
            s = logit_cap * torch.tanh(s / logit_cap)
        if sliding_window:
            pos = torch.arange(n, device=q.device)
            s = s.masked_fill(pos <= lens[b] - 1 - sliding_window, float("-inf"))
        p = torch.softmax(s, dim=-1)
        out[b] = torch.einsum("hgn,nhd->hgd", p, v).reshape(Hq, D).to(q.dtype)
    return out
