"""Ragged paged EXTEND attention over the chunked combined pool: the CUDA
kernel's wrapper, its plain PyTorch version, and the decode/extend routing.

Port of semi_pd_tpu/ops/attention/ragged_paged_attention.py::
ragged_paged_attention_chunked (TPU kernel _rpa_kernel_chunked,
ragged_paged_attention.py:803): causal attention of the flat new tokens of
every request over prefix + new tokens through the page table, driven by
the host work list (block_seq / block_row / block_qofs), with softcap and
sliding window. Routing is the JAX driver's: T == B goes to the decode
kernel (rpa_packed.py), everything else to the extend kernel
(ragged_paged_attention.py:1057,1100-1109). The TPU scheduling switches
(RPA_DECODE_STREAM, the VMEM clamps, the block_first contiguity table) are
not ported. The CUDA design is described in csrc/rpa_extend.cu.

Wrappers launch the kernel for CUDA tensors and use the plain version only
for tensors on the CPU; any other device raises. Nothing falls back.
"""

from __future__ import annotations

from typing import Optional

import torch

from semi_pd_tpu_torch.kernels import CudaKernel, cuda_stream_ptr, register
from semi_pd_tpu_torch.ops.attention.rpa_common import (
    F, I, P, check_cuda, check_pool_args, gather_kv, layer_kv5, layer_ptr,
)
from semi_pd_tpu_torch.ops.attention.rpa_packed import (
    ragged_paged_attention_chunked_packed,
    ragged_paged_attention_chunked_packed_plain,
)

# Query rows per extend work-list entry. The host work list
# (runtime/forward_batch.py::make_attn_meta_host) and the extend kernel
# (compiled with -DEXTEND_QBLK from this constant) both use it.
EXTEND_Q_BLOCK = 128

EXTEND_KERNEL = register(CudaKernel(
    name="rpa_extend",
    source="csrc/rpa_extend.cu",
    symbol="rpa_extend",
    argtypes=[P] * 10 + [I] * 7 + [F, F, I, I, P],
    replaces="semi_pd_tpu/ops/attention/ragged_paged_attention.py:803 _rpa_kernel_chunked",
    defines=(f"EXTEND_QBLK={EXTEND_Q_BLOCK}",),
))


def _no_spec(spec_anc, win_base):
    if spec_anc is not None or win_base is not None:
        raise NotImplementedError("speculation-tree masks (spec_anc) are ROADMAP A11")


def ragged_paged_attention_chunked(
    q, kv_cache, layer_idx, page_table, kv_lens, meta, *, page_size,
    num_kv_heads, head_dim, scale, logit_cap=None, sliding_window=None,
    spec_anc=None, win_base=None,
) -> torch.Tensor:
    """Attention of q [T, Hq, D] over the chunked pool [L, S, CT, 128]:
    T == B batches take the decode kernel, all others the extend kernel."""
    _no_spec(spec_anc, win_base)
    kw = dict(page_size=page_size, num_kv_heads=num_kv_heads, head_dim=head_dim,
              scale=scale, logit_cap=logit_cap, sliding_window=sliding_window)
    if q.shape[0] == page_table.shape[0]:
        return ragged_paged_attention_chunked_packed(
            q, kv_cache, layer_idx, page_table, kv_lens, **kw)
    return ragged_paged_attention_chunked_extend(
        q, kv_cache, layer_idx, page_table, kv_lens, meta, **kw)


def ragged_paged_attention_chunked_plain(
    q, kv_cache, layer_idx, page_table, kv_lens, meta, *, page_size,
    num_kv_heads, head_dim, scale, logit_cap=None, sliding_window=None,
    spec_anc=None, win_base=None,
) -> torch.Tensor:
    """The same routing over the two plain versions, on any device (used to
    hold the kernels to their plain versions at full width)."""
    _no_spec(spec_anc, win_base)
    kw = dict(page_size=page_size, num_kv_heads=num_kv_heads, head_dim=head_dim,
              scale=scale, logit_cap=logit_cap, sliding_window=sliding_window)
    if q.shape[0] == page_table.shape[0]:
        return ragged_paged_attention_chunked_packed_plain(
            q, kv_cache, layer_idx, page_table, kv_lens, **kw)
    return ragged_paged_attention_chunked_extend_plain(
        q, kv_cache, layer_idx, page_table, kv_lens, meta, **kw)


def ragged_paged_attention_chunked_extend(
    q: torch.Tensor,  # [T, Hq, D] flat new tokens
    kv_cache: torch.Tensor,  # [L, S, CT, 128]
    layer_idx: int,
    page_table: torch.Tensor,  # [B, maxP] int32
    kv_lens: torch.Tensor,  # [B] int32
    meta,  # runtime.forward_batch.AttnMeta
    *,
    page_size: int,
    num_kv_heads: int,
    head_dim: int,
    scale: float,
    logit_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Extend attention; rows no work-list entry owns stay 0."""
    check_pool_args(q, kv_cache, layer_idx, page_table, kv_lens, num_kv_heads, head_dim)
    if q.device.type == "cpu":
        return ragged_paged_attention_chunked_extend_plain(
            q, kv_cache, layer_idx, page_table, kv_lens, meta, page_size=page_size,
            num_kv_heads=num_kv_heads, head_dim=head_dim, scale=scale,
            logit_cap=logit_cap, sliding_window=sliding_window)
    if q.device.type != "cuda":
        raise RuntimeError(f"no extend kernel for device {q.device}")
    ints = (meta.q_lens, meta.q_start, meta.block_seq, meta.block_row, meta.block_qofs)
    if any(a.dtype != torch.int32 for a in ints):
        raise ValueError("work-list arrays must be int32")
    check_cuda(q, kv_cache, page_table, kv_lens, *ints)
    T, Hq, D = q.shape
    # zeros: bucket-padding rows stay finite when their K/V are later
    # scattered into the dump page
    out = torch.zeros_like(q)
    EXTEND_KERNEL.launch(
        q.data_ptr(), layer_ptr(kv_cache, layer_idx), page_table.data_ptr(),
        kv_lens.data_ptr(), *[a.data_ptr() for a in ints], out.data_ptr(),
        meta.block_seq.shape[0], Hq, num_kv_heads, D, kv_cache.shape[2] * 128,
        page_table.shape[1], page_size, float(scale), float(logit_cap or 0.0),
        int(sliding_window or 0), int(q.dtype == torch.bfloat16),
        cuda_stream_ptr(q.device))
    return out


def ragged_paged_attention_chunked_extend_plain(
    q, kv_cache, layer_idx, page_table, kv_lens, meta, *, page_size,
    num_kv_heads, head_dim, scale, logit_cap=None, sliding_window=None,
) -> torch.Tensor:
    """Plain version of the extend kernel: a loop over the work-list
    entries, each gathering its request's pages up to its last row's
    position, then a causal float32 softmax over them."""
    T, Hq, D = q.shape
    Hkv = num_kv_heads
    G = Hq // Hkv
    kv5 = layer_kv5(kv_cache, layer_idx, Hkv, D)
    seq, row, qofs = (meta.block_seq.tolist(), meta.block_row.tolist(),
                      meta.block_qofs.tolist())
    q_lens, q_start, lens = (meta.q_lens.tolist(), meta.q_start.tolist(),
                             kv_lens.tolist())
    cap = page_table.shape[1] * page_size
    out = torch.zeros_like(q)
    for i, b in enumerate(seq):
        if b < 0:
            continue
        n_rows = min(q_lens[b] - qofs[i], EXTEND_Q_BLOCK)
        q_abs = q_start[b] + qofs[i] + torch.arange(n_rows, device=q.device)
        n = min(lens[b], q_start[b] + qofs[i] + n_rows, cap)
        if n <= 0:
            continue
        k, v = gather_kv(kv5, page_table[b], n, page_size)
        r0 = row[i]
        qb = q[r0 : r0 + n_rows].float().reshape(n_rows, Hkv, G, D)
        s = torch.einsum("rhgd,nhd->rhgn", qb, k) * scale
        if logit_cap:
            s = logit_cap * torch.tanh(s / logit_cap)
        pos = torch.arange(n, device=q.device)[None, :]
        valid = pos <= q_abs[:, None]
        if sliding_window:
            valid &= pos > q_abs[:, None] - sliding_window
        s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
        p = torch.softmax(s, dim=-1)
        p = torch.where(valid.any(dim=-1)[:, None, None, None], p,
                        torch.zeros((), device=q.device))
        o = torch.einsum("rhgn,nhd->rhgd", p, v).reshape(n_rows, Hq, D)
        out[r0 : r0 + n_rows] = o.to(q.dtype)
    return out
