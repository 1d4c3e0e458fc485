"""Cross-request streaming DECODE attention: the CUDA kernels' wrappers.

Ports of the two TPU kernels of semi_pd_tpu/ops/attention/rpa_stream.py:

- ``ragged_paged_attention_chunked_stream``: the chunked pool
  ``[L, S, CT, 128]`` (TPU kernel _rpa_kernel_chunked_stream, :241);
- ``ragged_paged_attention_stream``: the aligned pool ``[L, 2, S, Hkv, D]``
  at head_dim 128 with bf16, float32 or fp8 KV (TPU kernel
  _rpa_kernel_stream, :28, its GQA branch), and with ``v_dim`` the MLA
  latent pool (the same kernel's MLA branch).

The stream is a decode SCHEDULE: it computes what the packed decode
computes (rpa_packed.py), one query row per request, with softcap and
without a sliding window or a speculation mask (the routing keeps those
batches on the packed decode, as the JAX routing does). The KV tiles of
many requests form one sequence fetched a fixed depth ahead across request
boundaries (csrc/rpa_stream.cu). The JAX package selects it with
``RPA_DECODE_STREAM=1`` and sets the ring depth with ``RPA_STREAM_NBUF``;
the port selects it with ``ServerArgs.decode_stream`` and builds the depth
in (STREAM_NBUF = 4, the JAX default). Its plain version is the decode's,
``rpa_packed.decode_attention_plain``.

The wrappers launch their kernel for CUDA tensors and use the plain version
only for tensors on the CPU; any other device raises, as does a pool with
no stream build. Nothing falls back.
"""

from __future__ import annotations

from typing import Optional

import torch

from semi_pd_tpu_torch.kernels import CudaKernel, register
from semi_pd_tpu_torch.ops.attention.rpa_common import kernel_family, pool_heads
from semi_pd_tpu_torch.ops.attention.rpa_packed import DECODE_ARGTYPES, decode_with

STREAM_KERNEL = register(CudaKernel(
    name="rpa_decode_stream",
    source="csrc/rpa_stream.cu",
    symbol="rpa_decode_stream",
    argtypes=DECODE_ARGTYPES,
    replaces="semi_pd_tpu/ops/attention/rpa_stream.py:241 _rpa_kernel_chunked_stream",
))

STREAM_ALIGNED_KERNEL = register(CudaKernel(
    name="rpa_decode_stream_aligned",
    source="csrc/rpa_stream.cu",
    symbol="rpa_decode_stream_aligned",
    argtypes=DECODE_ARGTYPES,
    replaces="semi_pd_tpu/ops/attention/rpa_stream.py:28 _rpa_kernel_stream (GQA branch)",
    defines=("RPA_ALIGNED",),
))

# The TPU kernel's MLA branch upcasts q and the latent rows to float32 and
# keeps P in float32 (RPA_P_F32)
STREAM_MLA_KERNEL = register(CudaKernel(
    name="rpa_decode_stream_mla",
    source="csrc/rpa_stream.cu",
    symbol="rpa_decode_stream_mla",
    argtypes=DECODE_ARGTYPES,
    replaces="semi_pd_tpu/ops/attention/rpa_stream.py:28 _rpa_kernel_stream (MLA branch)",
    defines=("RPA_MLA", "RPA_P_F32"),
))

# The streaming decode of each kernel family (rpa_common.kernel_family);
# the merged family (the 5D pool below head_dim 128) has none, as in JAX
STREAM_KERNELS = {"chunked": STREAM_KERNEL, "aligned": STREAM_ALIGNED_KERNEL,
                  "latent": STREAM_MLA_KERNEL}


def _stream(q, kv_cache, layer_idx, page_table, kv_lens, *, page_size, num_kv_heads,
            head_dim, scale, logit_cap, v_dim=None):
    family = kernel_family(kv_cache)
    if family not in STREAM_KERNELS:
        raise NotImplementedError(
            f"no streaming decode for the {family} kernels: the 5D pool below head_dim "
            f"128 decodes through its merged kernel, stream or not")
    return decode_with(STREAM_KERNELS[family], q, kv_cache, layer_idx, page_table, kv_lens,
                       page_size=page_size, num_kv_heads=num_kv_heads, head_dim=head_dim,
                       scale=scale, logit_cap=logit_cap, sliding_window=None, v_dim=v_dim)


def ragged_paged_attention_chunked_stream(
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
) -> torch.Tensor:
    """Streaming decode over the chunked pool: returns [B, Hq, D]; rows
    with kv_len == 0 are 0."""
    return _stream(q, kv_cache, layer_idx, page_table, kv_lens, page_size=page_size,
                   num_kv_heads=num_kv_heads, head_dim=head_dim, scale=scale,
                   logit_cap=logit_cap)


def ragged_paged_attention_stream(
    q: torch.Tensor,  # [B, Hq, D] one row per request (D = Dlat with v_dim)
    kv_cache: torch.Tensor,  # [L, 2, S, Hkv, 128], or [L, 1, S, 1, Dlat] with v_dim
    layer_idx: int,
    page_table: torch.Tensor,  # [B, maxP] int32
    kv_lens: torch.Tensor,  # [B] int32
    *,
    page_size: int,
    scale: float,
    logit_cap: Optional[float] = None,
    v_dim: Optional[int] = None,
) -> torch.Tensor:
    """Streaming decode over the aligned pool at head_dim 128 (Hkv and D
    from its shape), or with ``v_dim`` over the MLA latent pool: returns
    [B, Hq, D] (or [B, Hq, v_dim]); rows with kv_len == 0 are 0."""
    Hkv, D = pool_heads(kv_cache)
    return _stream(q, kv_cache, layer_idx, page_table, kv_lens, page_size=page_size,
                   num_kv_heads=Hkv, head_dim=D, scale=scale, logit_cap=logit_cap,
                   v_dim=v_dim)
