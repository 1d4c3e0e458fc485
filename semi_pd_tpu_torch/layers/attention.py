"""Attention layer: KV-pool write + kernel dispatch (port of the chunked-pool
branch of semi_pd_tpu/layers/attention.py::paged_attention).

Every model's attention calls ``paged_attention``, which (1) scatters the
step's fresh K/V into the shared pool at the scheduler-assigned slots, in
place (the JAX package's functional ``.at[].set``), and (2) runs the
ragged paged attention over the pool: the CUDA kernels for CUDA tensors,
their plain versions for CPU tensors (ops/attention/ragged_paged_attention.
py). The aligned 5D pool and fp8-KV scales are ROADMAP A9.
"""

from __future__ import annotations

from typing import Optional

import torch

from semi_pd_tpu_torch.ops.attention.ragged_paged_attention import (
    ragged_paged_attention_chunked,
)


def write_kv(kv_cache: torch.Tensor, layer_idx: int, out_slots: torch.Tensor,
             k_new: torch.Tensor, v_new: torch.Tensor) -> None:
    """Scatter K and V of T tokens into their slot rows of layer
    ``layer_idx`` of the chunked pool [L, S, CT, 128] (K chunks, then V
    chunks). Padded tokens carry slots in the dump page."""
    T, Hkv, D = k_new.shape
    val = torch.cat([k_new.reshape(T, Hkv * D // 128, 128),
                     v_new.reshape(T, Hkv * D // 128, 128)], dim=1)
    kv_cache[layer_idx][out_slots.long()] = val.to(kv_cache.dtype)


def paged_attention(
    q: torch.Tensor,  # [T, Hq, D]
    k_new: torch.Tensor,  # [T, Hkv, D]
    v_new: torch.Tensor,  # [T, Hkv, D]
    kv_cache: torch.Tensor,  # [L, S, CT, 128] — the whole pool, updated in place
    layer_idx: int,
    fb,  # runtime.forward_batch.ForwardArrays
    page_size: int,
    scale: float,
    logit_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
    attention=ragged_paged_attention_chunked,
) -> torch.Tensor:
    """Returns attn_out [T, Hq, D]. ``attention`` is the function run over
    the pool after the write; the default routes to the kernels."""
    if kv_cache.dim() != 4:
        raise NotImplementedError("only the chunked pool is ported; the aligned "
                                  "5D pool is ROADMAP A9")
    T, Hkv, D = k_new.shape
    write_kv(kv_cache, layer_idx, fb.out_slots, k_new, v_new)
    return attention(
        q.contiguous(), kv_cache, layer_idx, fb.page_table, fb.kv_lens,
        fb.attn_meta, page_size=page_size, num_kv_heads=Hkv, head_dim=D,
        scale=scale, logit_cap=logit_cap, sliding_window=sliding_window,
    )
