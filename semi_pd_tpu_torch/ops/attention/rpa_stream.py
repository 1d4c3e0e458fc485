"""Cross-request streaming DECODE attention: the CUDA kernels' wrappers.

Ports of the two TPU kernels of semi_pd_tpu/ops/attention/rpa_stream.py:

- ``ragged_paged_attention_chunked_stream``: the chunked pool
  ``[L, S, CT, 128]`` (TPU kernel _rpa_kernel_chunked_stream, :241);
- ``ragged_paged_attention_stream``: the aligned pool ``[L, 2, S, Hkv, D]``
  at head_dim 128 and 256, a build each (TPU kernel _rpa_kernel_stream,
  :28, its GQA branch),
  and with ``v_dim`` the MLA latent pool (the same kernel's MLA branch).

Each pool takes bf16, float32 or fp8 (e4m3, e5m2) KV, as the packed
decode does.

The stream is a decode SCHEDULE: it computes what the packed decode
computes (rpa_packed.py), one query row per request, with softcap and
without a sliding window or a speculation mask (the routing keeps those
batches on the packed decode, as the JAX routing does). The KV tiles of
many requests form one sequence fetched a fixed depth ahead across request
boundaries (csrc/rpa_stream.cu). With bf16 q the GQA builds cut that
sequence into equal shares of tiles, one per warp of a persistent grid of
``stream_blocks`` blocks per head group (rpa_packed.head_groups), on the
tensor cores, and the latent build into shares of whole 256-position
chunks, one per block (its four warps share each latent tile); requests
cut across blocks leave float32 partials in a scratch that a combine pass
merges. The JAX package selects
the stream with ``RPA_DECODE_STREAM=1`` and sets the ring depth with
``RPA_STREAM_NBUF``; the port selects it with ``ServerArgs.decode_stream``
and builds the depth in (STREAM_NBUF = 4, the JAX default). Its plain version is the decode's,
``rpa_packed.decode_attention_plain``.

The wrappers launch their kernel for CUDA tensors and use the plain version
only for tensors on the CPU; any other device raises, as does a pool with
no stream build. Nothing falls back.
"""

from __future__ import annotations

from typing import Optional

import torch

from semi_pd_tpu_torch.kernels import CudaKernel, register
from semi_pd_tpu_torch.ops.attention.rpa_common import (
    FP8, I, P, aligned_defines, kernel_family, latent_defines, pick_kernel, pool_heads,
)
from semi_pd_tpu_torch.ops.attention.rpa_packed import (
    DECODE_ARGTYPES, DECODE_MLA_KERNELS, DECODE_SPLIT, decode_split_plan, decode_with,
    group_rows, head_groups, sm_count,
)

# The streaming decodes' entry point: the decode's, then the tensor-core
# stream's plan (blocks per head group, scratch pointer) before the CUDA stream
STREAM_ARGTYPES = DECODE_ARGTYPES[:-1] + [I, P, P]

STREAM_KERNEL = register(CudaKernel(
    name="rpa_decode_stream",
    source="csrc/rpa_stream.cu",
    symbol="rpa_decode_stream",
    argtypes=STREAM_ARGTYPES,
    replaces="semi_pd_tpu/ops/attention/rpa_stream.py:241 _rpa_kernel_chunked_stream",
))

STREAM_ALIGNED_KERNEL = register(CudaKernel(
    name="rpa_decode_stream_aligned",
    source="csrc/rpa_stream.cu",
    symbol="rpa_decode_stream_aligned",
    argtypes=STREAM_ARGTYPES,
    replaces="semi_pd_tpu/ops/attention/rpa_stream.py:28 _rpa_kernel_stream (GQA branch)",
    defines=aligned_defines(128),
))

# Gemma-2's head_dim 256 (its full-attention layers under decode_stream)
STREAM_ALIGNED_256_KERNEL = register(CudaKernel(
    name="rpa_decode_stream_aligned_256",
    source="csrc/rpa_stream.cu",
    symbol="rpa_decode_stream_aligned_256",
    argtypes=STREAM_ARGTYPES,
    replaces="semi_pd_tpu/ops/attention/rpa_stream.py:28 _rpa_kernel_stream "
             "(GQA branch, head_dim 256)",
    defines=aligned_defines(256),
))

# The TPU kernel's MLA branch upcasts q and the latent rows to float32 and
# keeps P in float32 (RPA_P_F32); one build per latent geometry, as the
# packed decode's
STREAM_MLA_KERNEL = register(CudaKernel(
    name="rpa_decode_stream_mla",
    source="csrc/rpa_stream.cu",
    symbol="rpa_decode_stream_mla",
    argtypes=STREAM_ARGTYPES,
    replaces="semi_pd_tpu/ops/attention/rpa_stream.py:28 _rpa_kernel_stream (MLA branch)",
    defines=("RPA_MLA", "RPA_P_F32"),
))

STREAM_MLA_288_KERNEL = register(CudaKernel(
    name="rpa_decode_stream_mla_288",
    source="csrc/rpa_stream.cu",
    symbol="rpa_decode_stream_mla_288",
    argtypes=STREAM_ARGTYPES,
    replaces="semi_pd_tpu/ops/attention/rpa_stream.py:28 _rpa_kernel_stream "
             "(MLA branch, latent 288 / v_dim 256)",
    defines=("RPA_MLA", "RPA_P_F32", *latent_defines(288)),
))
# the latent streams by latent width, and each one's packed decode (whose
# chunks and blocks per SM it shares)
STREAM_MLA_KERNELS = {576: STREAM_MLA_KERNEL, 288: STREAM_MLA_288_KERNEL}
STREAM_MLA_DECODE = {STREAM_MLA_KERNELS[w].name: DECODE_MLA_KERNELS[w].name
                     for w in STREAM_MLA_KERNELS}

# The streaming decode of each kernel family (rpa_common.kernel_family;
# rpa_common.pick_kernel); the merged family (the 5D pool below head_dim
# 128) has none, as in JAX
STREAM_KERNELS = {"chunked": STREAM_KERNEL,
                  "aligned": {128: STREAM_ALIGNED_KERNEL, 256: STREAM_ALIGNED_256_KERNEL},
                  "latent": STREAM_MLA_KERNELS}


# The tensor-core streams' schedules (tests/test_torch_stream_split.py and
# tests/test_torch_mla_decode_split.py hold them equal to the sources'
# constants): the KV positions of the unit a share is cut in, a warp tile
# of 1024 / head_dim in the GQA builds (16 at 64, 8 at 128, and 8 at 256,
# mma's least; csrc/rpa_stream.cu STREAM_TK) and the packed MLA decode's
# fixed chunk in the latent build (csrc/rpa_mla_mma.cuh MLA_MMA_CHUNK); the
# ring depth of each GQA warp, the warps of a block and, per GQA build, the
# blocks an SM holds at once with bf16 KV and with fp8 KV (one at head_dim
# 256, where a warp's ring is 33 KB; the latent build's: rpa_packed.DECODE_SPLIT)
STREAM_TILE = {STREAM_KERNEL.name: 16, STREAM_ALIGNED_KERNEL.name: 8,
               STREAM_ALIGNED_256_KERNEL.name: 8,
               **{s: DECODE_SPLIT[d][0] for s, d in STREAM_MLA_DECODE.items()}}
STREAM_NBUF = 4
STREAM_WARPS = 4
STREAM_BLOCKS_PER_SM = {STREAM_KERNEL.name: (2, 3), STREAM_ALIGNED_KERNEL.name: (2, 3),
                        STREAM_ALIGNED_256_KERNEL.name: (1, 1)}


def stream_blocks(build: str, B: int, Hkv: int, max_kv: int, num_sms: int,
                  fp8: bool = False) -> int:
    """P, the blocks per head group (``Hkv`` is rpa_packed.head_groups: the
    KV heads at G <= 16) of a build's tensor-core stream
    (``build``: a key of STREAM_TILE; ``fp8``: fp8 KV): as many as the card
    holds at once beside the other columns, but no more than a batch of
    full page tables (max_kv = maxP * page_size positions each) gives each
    of its shares a unit of STREAM_TILE: a tile to each of a GQA block's 4
    warps, a chunk to a latent block. From the shapes, the build, the KV
    type and the SM count only: the wrapper never reads kv_lens."""
    if build in STREAM_MLA_DECODE:
        per_sm, shares = DECODE_SPLIT[STREAM_MLA_DECODE[build]][1], 1
    else:
        per_sm, shares = STREAM_BLOCKS_PER_SM[build][fp8], STREAM_WARPS
    most = B * -(-max_kv // STREAM_TILE[build])
    return max(1, min(per_sm * num_sms // max(Hkv, 1), -(-most // shares)))


def stream_scratch_floats(n_blocks: int, rows: int, groups: int, D: int) -> int:
    """Float32 elements of a GQA build's tensor-core stream scratch over
    ``groups`` head groups of ``rows`` rows in all (rpa_packed.group_rows
    each; Hq rows at G <= 16): one partial of a group's rows (O, D wide,
    then m and l) per warp and head group (a request cut at the warp's
    first tile), two per block and head group (requests cut across
    blocks), then one int4 descriptor per block and head group."""
    return n_blocks * (6 * rows * (D + 2) + 4 * groups)


def stream_args(kernel, q, kv_dtype, num_kv_heads, max_kv, dv):
    """The stream entry's plan, (n_blocks, scratch pointer), and the scratch
    tensor, with bf16 q (partials dv wide, the output's width): the latent
    build's holds a partial per chunk and row, laid out as the packed
    decode's splits; one block and no scratch for the float32 pairs (the
    CUDA-core kernels take their own grid)."""
    if kernel.name not in STREAM_TILE or q.dtype != torch.bfloat16:
        return (1, None), None
    B, Hq, _ = q.shape
    heads = head_groups(kernel, Hq, num_kv_heads)
    sms = sm_count(q.device.index or 0)
    n = stream_blocks(kernel.name, B, heads, max_kv, sms, fp8=kv_dtype in FP8)
    if kernel.name in STREAM_MLA_DECODE:
        n_chunk, _ = decode_split_plan(STREAM_MLA_DECODE[kernel.name], B, heads, max_kv, sms)
        floats = n_chunk * B * Hq * (dv + 2)
    else:
        floats = stream_scratch_floats(n, heads * group_rows(Hq, num_kv_heads), heads, dv)
    scratch = q.new_empty(floats, dtype=torch.float32)
    return (n, scratch.data_ptr()), scratch


def _stream(q, kv_cache, layer_idx, page_table, kv_lens, *, page_size, num_kv_heads,
            head_dim, scale, logit_cap, v_dim=None):
    family = kernel_family(kv_cache)
    if family not in STREAM_KERNELS:
        raise NotImplementedError(
            f"no streaming decode for the {family} kernels: the 5D pool below head_dim "
            f"128 decodes through its merged kernel, stream or not")
    return decode_with(pick_kernel(STREAM_KERNELS, kv_cache), q, kv_cache, layer_idx,
                       page_table, kv_lens,
                       page_size=page_size, num_kv_heads=num_kv_heads, head_dim=head_dim,
                       scale=scale, logit_cap=logit_cap, sliding_window=None, v_dim=v_dim,
                       plan=stream_args)


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
    kv_cache: torch.Tensor,  # [L, 2, S, Hkv, 128 or 256], or [L, 1, S, 1, Dlat] with v_dim
    layer_idx: int,
    page_table: torch.Tensor,  # [B, maxP] int32
    kv_lens: torch.Tensor,  # [B] int32
    *,
    page_size: int,
    scale: float,
    logit_cap: Optional[float] = None,
    v_dim: Optional[int] = None,
) -> torch.Tensor:
    """Streaming decode over the aligned pool at head_dim 128 or 256 (Hkv
    and D from its shape), or with ``v_dim`` over the MLA latent pool: returns
    [B, Hq, D] (or [B, Hq, v_dim]); rows with kv_len == 0 are 0."""
    Hkv, D = pool_heads(kv_cache)
    return _stream(q, kv_cache, layer_idx, page_table, kv_lens, page_size=page_size,
                   num_kv_heads=Hkv, head_dim=D, scale=scale, logit_cap=logit_cap,
                   v_dim=v_dim)
