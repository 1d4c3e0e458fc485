"""Paged DECODE attention over any KV pool: the CUDA kernels' wrappers and
their plain PyTorch version.

Ports of four TPU kernels (branches):

- ``ragged_paged_attention_chunked_packed``: the chunked pool
  ``[L, S, CT, 128]`` (TPU kernel rpa_packed.py:32
  _rpa_kernel_chunked_packed);
- ``ragged_paged_attention_packed``: the aligned pool ``[L, 2, S, Hkv, D]``
  (TPU kernel rpa_packed.py:349 _rpa_kernel_packed, its GQA branch, at
  head_dim 128 and 256, a build each; below 128 the decode
  of ragged_paged_attention.py:300 _rpa_kernel_merged, which the JAX
  dispatcher runs for every D % 128 != 0 batch on that pool), and with
  ``v_dim`` the MLA latent pool ``[L, 1, S, 1, Dlat]`` (_rpa_kernel_packed's
  MLA branch: one latent head shared by all Hq query heads, V the first
  v_dim elements of each row).

One query row per request at position kv_len - 1; GQA, f32 online softmax,
optional logit softcap and sliding window. Every pool takes bf16, float32
or fp8 (e4m3, e5m2) KV; fp8 is upcast exactly, as the TPU kernels upcast
it to q's dtype (to float32 in the MLA branch). The TPU kernels' rpb/SUB request
packing and their RPA_DECODE_PACKED / RPA_PACKED_DIAG switches schedule
work for the TPU and are not ported; the CUDA designs are described in
csrc/rpa_decode.cu, csrc/rpa_mla.cuh and csrc/rpa_mla_mma.cuh.

The wrappers launch their kernel for CUDA tensors and use
``decode_attention_plain`` only for tensors on the CPU; any other device
raises. Nothing falls back.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from semi_pd_tpu_torch.kernels import CudaKernel, cuda_stream_ptr, register
from semi_pd_tpu_torch.ops.attention.rpa_common import (
    F, I, P, TYPE_CODES, alibi_bias, alibi_build, aligned_defines, check_alibi, check_cuda,
    check_pool_args, gather_kv, kv_planes, latent_defines, layer_kv, pick_kernel, pool_heads,
)

# The decode kernels' arguments up to the CUDA stream (the streaming
# decodes append their plan, rpa_stream.py)
DECODE_ARGTYPES = [P] * 6 + [I] * 7 + [F, F, I, I, I, P]
# The packed decode builds (csrc/rpa_decode.cu, csrc/rpa_decode_mla.cu)
# share one entry point, which also takes the split plan of their
# tensor-core kernel (decode_split_plan), a scratch pointer and ALiBi's
# slopes (null: none)
SPLIT_DECODE_ARGTYPES = DECODE_ARGTYPES[:-1] + [I, I, P, P, P]

DECODE_KERNEL = register(CudaKernel(
    name="rpa_decode",
    source="csrc/rpa_decode.cu",
    symbol="rpa_decode",
    argtypes=SPLIT_DECODE_ARGTYPES,
    replaces="semi_pd_tpu/ops/attention/rpa_packed.py:32 _rpa_kernel_chunked_packed",
))

DECODE_ALIGNED_KERNEL = register(CudaKernel(
    name="rpa_decode_aligned",
    source="csrc/rpa_decode.cu",
    symbol="rpa_decode_aligned",
    argtypes=SPLIT_DECODE_ARGTYPES,
    replaces="semi_pd_tpu/ops/attention/rpa_packed.py:349 _rpa_kernel_packed (GQA branch)",
    defines=aligned_defines(128),
))

# ALiBi (Baichuan2-13B): the aligned build's ALIBI instantiation, which its
# entry launches when given the slopes. The JAX layer runs ALiBi through its
# reference attention (semi_pd_tpu/layers/attention.py:137,
# ops/attention/reference.py:86-90): this is that function on the packed
# decode's schedule
DECODE_ALIGNED_ALIBI_KERNEL = register(DECODE_ALIGNED_KERNEL.instantiation(
    "rpa_decode_aligned_alibi",
    "semi_pd_tpu/ops/attention/rpa_packed.py:349 _rpa_kernel_packed (GQA branch, with the "
    "ALiBi bias of ops/attention/reference.py:86-90)"))
# build -> its ALiBi instantiation (rpa_common.alibi_build)
DECODE_ALIBI = {DECODE_ALIGNED_KERNEL.name: DECODE_ALIGNED_ALIBI_KERNEL}

# Gemma-2's head_dim 256 on the 5D pool: the same kernels, Q's fragments
# read from shared memory (csrc/rpa_decode.cu)
DECODE_ALIGNED_256_KERNEL = register(CudaKernel(
    name="rpa_decode_aligned_256",
    source="csrc/rpa_decode.cu",
    symbol="rpa_decode_aligned_256",
    argtypes=SPLIT_DECODE_ARGTYPES,
    replaces="semi_pd_tpu/ops/attention/rpa_packed.py:349 _rpa_kernel_packed "
             "(GQA branch, head_dim 256)",
    defines=aligned_defines(256),
))

# The TPU kernel's MLA branch upcasts q and the latent rows to float32 and
# keeps P in float32 (RPA_P_F32). One build per latent geometry
# (rpa_common.LATENT_BUILDS): DeepSeek-V2's 576 / 512 and MiniCPM3's 288 /
# 256, the TPU branch's width-generic code (it zero-pads q and the rows)
DECODE_MLA_KERNEL = register(CudaKernel(
    name="rpa_decode_mla",
    source="csrc/rpa_decode_mla.cu",
    symbol="rpa_decode_mla",
    argtypes=SPLIT_DECODE_ARGTYPES,
    replaces="semi_pd_tpu/ops/attention/rpa_packed.py:349 _rpa_kernel_packed (MLA branch)",
    defines=("RPA_P_F32",),
))

DECODE_MLA_288_KERNEL = register(CudaKernel(
    name="rpa_decode_mla_288",
    source="csrc/rpa_decode_mla.cu",
    symbol="rpa_decode_mla_288",
    argtypes=SPLIT_DECODE_ARGTYPES,
    replaces="semi_pd_tpu/ops/attention/rpa_packed.py:349 _rpa_kernel_packed "
             "(MLA branch, latent 288 / v_dim 256)",
    defines=("RPA_P_F32", *latent_defines(288)),
))
# the latent decodes by latent width
DECODE_MLA_KERNELS = {576: DECODE_MLA_KERNEL, 288: DECODE_MLA_288_KERNEL}

# The 5D pool at head_dim 64: _rpa_kernel_merged computes in float32
# throughout, P included, so this build keeps P in float32 (RPA_P_F32)
MERGED_DEFINES = ("RPA_ALIGNED", "RPA_HEAD_DIM=64", "RPA_P_F32")

DECODE_MERGED_KERNEL = register(CudaKernel(
    name="rpa_decode_merged",
    source="csrc/rpa_decode.cu",
    symbol="rpa_decode_merged",
    argtypes=SPLIT_DECODE_ARGTYPES,
    replaces="semi_pd_tpu/ops/attention/ragged_paged_attention.py:300 _rpa_kernel_merged "
             "(decode)",
    defines=MERGED_DEFINES,
))

# The decode kernel of each kernel family of the 5D and the latent pool
# (rpa_common.kernel_family; rpa_common.pick_kernel)
DECODE_KERNELS = {"aligned": {128: DECODE_ALIGNED_KERNEL, 256: DECODE_ALIGNED_256_KERNEL},
                  "merged": DECODE_MERGED_KERNEL, "latent": DECODE_MLA_KERNELS}

# The split plan's constants of each packed decode build's tensor-core
# kernel, as its source states them (tests/test_torch_decode_split.py and
# tests/test_torch_mla_decode_split.py hold the two equal): (the positions
# split_len must be a multiple of; the blocks an SM holds at once with bf16
# KV). The GQA builds (csrc/rpa_decode.cu, for the build's head_dim):
# SD_STEP, the positions a block walks per round, 4 warps x SD_TK = 2048 /
# head_dim, and SD_BLOCKS_PER_SM, about 105 KB of shared memory a block at
# head_dim 64 and 128, 107 KB at 256 (8-position tiles and the block's Q
# tile). The latent builds (csrc/rpa_mla_mma.cuh):
# MLA_MMA_CHUNK, the fixed chunk they split every request at, and
# MLA_MMA_BLOCKS_PER_SM, as many blocks as the shared memory holds (81 KB a
# block at 576, 45 KB at 288).
DECODE_SPLIT = {DECODE_KERNEL.name: (128, 2), DECODE_ALIGNED_KERNEL.name: (64, 2),
                DECODE_ALIGNED_ALIBI_KERNEL.name: (64, 2),
                DECODE_ALIGNED_256_KERNEL.name: (32, 2), DECODE_MERGED_KERNEL.name: (128, 2),
                DECODE_MLA_KERNEL.name: (256, 2), DECODE_MLA_288_KERNEL.name: (256, 4)}
# the GQA decodes' and streams' float32 (CUDA-core) kernels: G * head_dim
# outputs of a block, at most DEC_MAXO * DEC_NT (csrc/rpa_decode.cuh)
F32_DECODE_MAX_GD = 8 * 128
# the latent builds' names (their plan is the fixed chunk)
MLA_DECODES = frozenset(k.name for k in DECODE_MLA_KERNELS.values())
# a GQA build's split covers at least SPLIT_MIN positions (unless the page
# table is shorter)
SPLIT_MIN = 512
# query heads per block of the tensor-core decodes and streams (the rows of
# one m16 tile: csrc/rpa_mla_mma.cuh MLA_MMA_ROWS, csrc/rpa_decode_mma.cuh
# mma_head_group)
MLA_ROWS = 16


def head_groups(kernel, Hq: int, num_kv_heads: int) -> int:
    """The second grid dimension of a tensor-core decode or stream: the
    head groups of at most MLA_ROWS query heads. On the latent pool (one
    latent head) group h is the heads [16 h, min(16 h + 16, Hq)): one for
    DeepSeek-V2-Lite's 16, three (16 / 16 / 8) for MiniCPM3's 40. A GQA
    build cuts each KV head's G = Hq / Hkv heads alike, group j of KV head
    h the heads [h G + 16 j, h G + min(16 j + 16, G)): Hkv groups at G <=
    16, three a KV head at StarCoder's multi-query G = 48, five (16 x 4 + 7)
    at Falcon-7B's 71."""
    if "_mla" in kernel.name:
        return -(-Hq // MLA_ROWS)
    return num_kv_heads * -(-(Hq // num_kv_heads) // MLA_ROWS)


def group_rows(Hq: int, num_kv_heads: int) -> int:
    """Rows a GQA build's head group keeps in a scratch: G = Hq / Hkv up to
    MLA_ROWS, else MLA_ROWS (the last group of a KV head may use fewer)."""
    return min(Hq // num_kv_heads, MLA_ROWS)


def decode_split_plan(build: str, B: int, Hkv: int, max_kv: int, num_sms: int):
    """(n_split, split_len) of a packed decode build's tensor-core kernel
    (``build``: a key of DECODE_SPLIT; ``Hkv``: its head_groups, the KV
    heads at G <= 16): [0, max_kv) cut in order into n_split ranges [s *
    split_len, min((s + 1) * split_len, max_kv)). From the shapes, the build and the card's SM count
    only (max_kv = maxP * page_size; no kv_lens), so the wrapper never waits
    for the card. A GQA build takes enough splits that the B * Hkv *
    n_split blocks fill the card once at its blocks per SM, split_len at
    least SPLIT_MIN (unless max_kv is shorter) and a multiple of its step.
    The latent builds split at their fixed chunk (their step), whatever the
    batch and the head groups, so that a request's output does not depend
    on the batch around it and equals the streaming decode's
    (csrc/rpa_mla_mma.cuh); at DeepSeek-V2-Lite's phase-2 shapes that is
    also the plan that fills the card (two blocks an SM at b64 / kv1024 and
    b16 / kv4096; MiniCPM3's three head groups at four an SM, 768 blocks,
    fill it 1.45 times)."""
    step, blocks_per_sm = DECODE_SPLIT[build]
    if build in MLA_DECODES:
        return max(1, -(-max_kv // step)), step
    want = max(1, blocks_per_sm * num_sms // max(B * Hkv, 1))
    n = max(1, min(want, max_kv // SPLIT_MIN))
    split_len = -(-max(max_kv, 1) // n)
    split_len = -(-split_len // step) * step
    return max(1, -(-max_kv // split_len)), split_len


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_args(kernel, q, kv_dtype, num_kv_heads, max_kv, dv):
    """The split plan of a packed decode build's tensor-core kernel as its
    entry takes it, (n_split, split_len, scratch pointer), and the scratch
    tensor (None with one split): each split's float32 partial, dv wide
    (the output's width: the latent pool's V), then merged."""
    B, Hq, _ = q.shape
    n_split, split_len = decode_split_plan(kernel.name, B, head_groups(kernel, Hq, num_kv_heads),
                                           max_kv, sm_count(q.device.index or 0))
    scratch = (q.new_empty(n_split * B * Hq * (dv + 2), dtype=torch.float32)
               if n_split > 1 else None)
    return (n_split, split_len, None if scratch is None else scratch.data_ptr()), scratch


def decode_with(kernel, q, kv_cache, layer_idx, page_table, kv_lens, *, page_size,
                num_kv_heads, head_dim, scale, logit_cap, sliding_window, v_dim=None,
                plan=None, alibi_slopes=None):
    """Checks the arguments, then the plain version on the CPU or the
    kernel on the card. ``plan(kernel, q, kv dtype, num_kv_heads, maxP *
    page_size, output width)`` gives the entry's arguments between the
    element types and the stream, and a tensor to keep alive over the
    launch; packed decode builds default to their split plan, and their
    entries take ALiBi's slopes after it (null without ``alibi_slopes``),
    which launch the kernel's ALIBI instantiation (DECODE_ALIBI)."""
    check_pool_args(q, kv_cache, layer_idx, page_table, kv_lens, num_kv_heads, head_dim,
                    v_dim)
    check_alibi(alibi_slopes, q, v_dim=v_dim)
    if q.shape[0] != page_table.shape[0]:
        raise ValueError("decode takes one query row per request (T == B)")
    kw = dict(page_size=page_size, num_kv_heads=num_kv_heads, head_dim=head_dim,
              scale=scale, logit_cap=logit_cap, sliding_window=sliding_window, v_dim=v_dim)
    if q.device.type == "cpu":
        return decode_attention_plain(q, kv_cache, layer_idx, page_table, kv_lens,
                                      alibi_slopes=alibi_slopes, **kw)
    if q.device.type != "cuda":
        raise RuntimeError(f"no decode kernel for device {q.device}")
    if alibi_slopes is not None:
        kernel = alibi_build(kernel, DECODE_ALIBI)
    check_cuda(q, kv_cache, page_table, kv_lens, v_dim=v_dim)
    if v_dim is None and q.dtype == torch.float32 and (
            q.shape[1] // num_kv_heads) * head_dim > F32_DECODE_MAX_GD:
        raise NotImplementedError(
            f"float32 decode at {q.shape[1] // num_kv_heads} query heads per KV head and "
            f"head_dim {head_dim}: the GQA decodes' float32 kernels hold G * head_dim <= "
            f"{F32_DECODE_MAX_GD} outputs a block (ChatGLM's G = 16 at 128 is bf16 only); "
            f"ROADMAP B9.7")
    B, Hq, D = q.shape
    Dv = v_dim or D
    k_ptr, v_ptr, row_stride = kv_planes(kv_cache, layer_idx, num_kv_heads, D)
    out = q.new_empty((B, Hq, Dv))
    maxP = page_table.shape[1]
    if plan is None and kernel.name in DECODE_SPLIT:
        plan = split_args
    extra, _scratch = (plan(kernel, q, kv_cache.dtype, num_kv_heads, maxP * page_size, Dv)
                       if plan else ((), None))
    if kernel.name in DECODE_SPLIT:
        extra = (*extra, None if alibi_slopes is None else alibi_slopes.data_ptr())
    kernel.launch(
        q.data_ptr(), k_ptr, v_ptr, page_table.data_ptr(), kv_lens.data_ptr(),
        out.data_ptr(), B, Hq, num_kv_heads, D, row_stride, maxP,
        page_size, float(scale), float(logit_cap or 0.0), int(sliding_window or 0),
        TYPE_CODES[q.dtype], TYPE_CODES[kv_cache.dtype], *extra, cuda_stream_ptr(q.device))
    return out


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
    """Decode attention over the chunked pool: returns [B, Hq, D]; rows
    with kv_len == 0 are 0."""
    return decode_with(DECODE_KERNEL, q, kv_cache, layer_idx, page_table, kv_lens,
                   page_size=page_size, num_kv_heads=num_kv_heads, head_dim=head_dim,
                   scale=scale, logit_cap=logit_cap, sliding_window=sliding_window)


def ragged_paged_attention_packed(
    q: torch.Tensor,  # [B, Hq, D] one row per request (D = Dlat with v_dim)
    kv_cache: torch.Tensor,  # [L, 2, S, Hkv, D], or [L, 1, S, 1, Dlat] with v_dim
    layer_idx: int,
    page_table: torch.Tensor,  # [B, maxP] int32
    kv_lens: torch.Tensor,  # [B] int32
    *,
    page_size: int,
    scale: float,
    logit_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
    v_dim: Optional[int] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode attention over the aligned pool (Hkv and D from its shape;
    the build of its head_dim, 128 or 256; the merged kernel below 128), or with ``v_dim`` over the MLA
    latent pool: returns [B, Hq, D] (or [B, Hq, v_dim]); rows with kv_len
    == 0 are 0. ``alibi_slopes`` (float32 [Hq]): ALiBi's bias, in the
    aligned head_dim-128 build's ALiBi instantiation on the card."""
    Hkv, D = pool_heads(kv_cache)
    return decode_with(pick_kernel(DECODE_KERNELS, kv_cache), q, kv_cache, layer_idx,
                       page_table, kv_lens, page_size=page_size, num_kv_heads=Hkv, head_dim=D,
                       scale=scale, logit_cap=logit_cap, sliding_window=sliding_window,
                       v_dim=v_dim, alibi_slopes=alibi_slopes)


def ragged_paged_attention_packed_plain(
    q, kv_cache, layer_idx, page_table, kv_lens, *, page_size, scale,
    logit_cap=None, sliding_window=None, v_dim=None, alibi_slopes=None,
) -> torch.Tensor:
    """Plain version of the aligned, the merged and the MLA decode
    kernels."""
    Hkv, D = pool_heads(kv_cache)
    return decode_attention_plain(q, kv_cache, layer_idx, page_table, kv_lens,
                                  page_size=page_size, num_kv_heads=Hkv, head_dim=D,
                                  scale=scale, logit_cap=logit_cap,
                                  sliding_window=sliding_window, v_dim=v_dim,
                                  alibi_slopes=alibi_slopes)


def decode_attention_plain(
    q, kv_cache, layer_idx, page_table, kv_lens, *, page_size, num_kv_heads,
    head_dim, scale, logit_cap=None, sliding_window=None, v_dim=None, alibi_slopes=None,
) -> torch.Tensor:
    """Plain version of the decode kernels, on any pool: a loop over
    requests, each gathering its pages, then a full float32 softmax (with
    ``alibi_slopes`` ALiBi's bias after the scale and the softcap, the
    query at kv_len - 1)."""
    B, Hq, D = q.shape
    Hkv = num_kv_heads
    G = Hq // Hkv
    Dv = v_dim or D
    k_layer, v_layer = layer_kv(kv_cache, layer_idx, Hkv, D, v_dim)
    lens = kv_lens.tolist()
    cap = page_table.shape[1] * page_size
    out = q.new_zeros((B, Hq, Dv))
    for b in range(B):
        n = min(lens[b], cap)
        if n <= 0:
            continue
        k, v = gather_kv(k_layer, v_layer, page_table[b], n, page_size)
        s = torch.einsum("hgd,nhd->hgn", q[b].float().reshape(Hkv, G, D), k) * scale
        if logit_cap:
            s = logit_cap * torch.tanh(s / logit_cap)
        pos = torch.arange(n, device=q.device)
        if alibi_slopes is not None:
            s = s + alibi_bias(alibi_slopes, Hkv, torch.full((1, 1), lens[b] - 1,
                                                             device=q.device), pos[None])[0]
        if sliding_window:
            s = s.masked_fill(pos <= lens[b] - 1 - sliding_window, float("-inf"))
        p = torch.softmax(s, dim=-1)
        out[b] = torch.einsum("hgn,nhd->hgd", p, v).reshape(Hq, Dv).to(q.dtype)
    return out
