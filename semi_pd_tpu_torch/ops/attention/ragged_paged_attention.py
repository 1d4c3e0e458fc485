"""Ragged paged EXTEND attention over any KV pool: the CUDA kernels'
wrappers, their plain PyTorch version, and the decode/extend routing.

Ports of four TPU kernels (branches) of semi_pd_tpu/ops/attention/
ragged_paged_attention.py:

- ``ragged_paged_attention_chunked``: the chunked pool ``[L, S, CT, 128]``
  (TPU kernel _rpa_kernel_chunked, :803);
- ``ragged_paged_attention``: the aligned (5D) pool ``[L, 2, S, Hkv, D]``
  (TPU kernel _rpa_kernel, :59, its GQA branch, at head_dim 128 and 256, a
  build each; below 128
  the extend of _rpa_kernel_merged, :300), and with ``v_dim`` the MLA
  latent pool ``[L, 1, S, 1, Dlat]`` (the same TPU kernel's MLA ``v_dim``
  branch; output [T, Hq, v_dim]).

Every pool holds bf16, float32 or fp8 (e4m3, e5m2) KV; fp8 is widened
exactly, to bf16 in the kernels (bf16 q) and to float32 in the plain
versions, as the TPU kernels widen it to q's dtype (GQA) or to float32
(the MLA branches). No wrapper converts the pool before a launch.

Causal attention of the flat new tokens of every request over prefix + new
tokens through the page table, driven by the host work list (block_seq /
block_row / block_qofs), with softcap and sliding window. Routing is the
JAX wrappers': T == B goes to the decode kernel of the pool (rpa_packed.py)
or, with ``stream``, to its streaming decode (rpa_stream.py; the JAX
package's RPA_DECODE_STREAM=1), everything else to its extend kernel
(ragged_paged_attention.py:502, 548-612, 1057, 1086-1122). The 5D pool
below head_dim 128 takes its merged kernels for decode and extend alike,
stream or not (:548 comes first). The JAX MLA extend runs 64-row q-blocks
against the 128-row work list and leaves rows 64-127 of each entry
unwritten (ROADMAP C1); here every extend kernel, the MLA one included, is
built with the work list's EXTEND_Q_BLOCK.

Speculation trees: ``spec_anc`` (the static ancestor masks of the tree's
nodes, speculative/tree.py) with ``win_base`` [B] (each request's window
start) refine the causal mask in every extend kernel, the four GQA builds
and the two MLA ones, and in their plain version (rpa_common.spec_tree_mask,
the TPU kernels' _spec_tree_mask, which _rpa_kernel applies to its GQA and
MLA branches alike). A sliding window inside a tree is tested against the
row's slot-order position, as _rpa_kernel tests it (:220-224): tree node i
of a request whose tree starts at b sees positions above b + i - window.
A batch with ``spec_anc`` always takes the extend kernel,
a decode-shaped one (T == B, the tree's draft steps) included, as the JAX
routing does (:569, :1092-1101), on the latent pool too: never a decode or
a stream; the work list's q_start is then the slot-order start the causal
test compares (the JAX reference's ``mask_pos``). Not ported: the TPU
scheduling switches (RPA_DECODE_PACKED,
the VMEM clamps and the block_first table have no GPU meaning). The CUDA
designs are described in csrc/rpa_extend.cu and csrc/rpa_mla.cuh.

Wrappers launch their kernel for CUDA tensors and use the plain version
only for tensors on the CPU; any other device raises. Nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from semi_pd_tpu_torch.kernels import CudaKernel, cuda_stream_ptr, register
from semi_pd_tpu_torch.ops.attention.rpa_common import (
    F, I, P, TYPE_CODES, alibi_bias, alibi_build, aligned_defines, check_alibi, check_cuda,
    check_pool_args, check_spec, gather_kv, kernel_family, kv_planes, latent_defines, layer_kv,
    pick_kernel, pool_heads, spec_tree_mask,
)
from semi_pd_tpu_torch.ops.attention.rpa_packed import (
    MERGED_DEFINES,
    decode_attention_plain,
    ragged_paged_attention_chunked_packed,
    ragged_paged_attention_packed,
    ragged_paged_attention_packed_plain,
)
from semi_pd_tpu_torch.ops.attention.rpa_stream import (
    ragged_paged_attention_chunked_stream,
    ragged_paged_attention_stream,
)
from semi_pd_tpu_torch.speculative.tree import MAX_TREE_NODES

# Query rows per extend work-list entry. The host work list
# (runtime/forward_batch.py::make_attn_meta_host) and the extend kernels
# (compiled with -DEXTEND_QBLK from this constant) all use it.
EXTEND_Q_BLOCK = 128

# the pointers, the shapes, scale and cap, window and the types, then the
# speculation tree (its node count W, its masks as a host array of
# MAX_TREE_NODES int32 the C entry copies into the kernel's parameters,
# win_base on the card), ALiBi's slopes (null: none) and the stream: every
# extend build, the MLA one included
_ARGTYPES = [P] * 11 + [I] * 7 + [F, F, I, I, I, I, P, P, P, P]

EXTEND_KERNEL = register(CudaKernel(
    name="rpa_extend",
    source="csrc/rpa_extend.cu",
    symbol="rpa_extend",
    argtypes=_ARGTYPES,
    replaces="semi_pd_tpu/ops/attention/ragged_paged_attention.py:803 _rpa_kernel_chunked",
    defines=(f"EXTEND_QBLK={EXTEND_Q_BLOCK}",),
))

EXTEND_ALIGNED_KERNEL = register(CudaKernel(
    name="rpa_extend_aligned",
    source="csrc/rpa_extend.cu",
    symbol="rpa_extend_aligned",
    argtypes=_ARGTYPES,
    replaces="semi_pd_tpu/ops/attention/ragged_paged_attention.py:59 _rpa_kernel (GQA branch)",
    defines=(f"EXTEND_QBLK={EXTEND_Q_BLOCK}", *aligned_defines(128)),
))

# ALiBi (Baichuan2-13B): the aligned build's ALIBI instantiation, which its
# entry launches when given the slopes, never with a tree. The JAX layer
# runs ALiBi through its reference attention
# (semi_pd_tpu/layers/attention.py:137, ops/attention/reference.py:86-90):
# this is that function on the extend's schedule
EXTEND_ALIGNED_ALIBI_KERNEL = register(EXTEND_ALIGNED_KERNEL.instantiation(
    "rpa_extend_aligned_alibi",
    "semi_pd_tpu/ops/attention/ragged_paged_attention.py:59 _rpa_kernel (GQA branch, with the "
    "ALiBi bias of ops/attention/reference.py:86-90)"))
# build -> its ALiBi instantiation (rpa_common.alibi_build)
EXTEND_ALIBI = {EXTEND_ALIGNED_KERNEL.name: EXTEND_ALIGNED_ALIBI_KERNEL}

# Gemma-2's head_dim 256 on the 5D pool (csrc/rpa_extend.cu's WG256_*
# shape: Q read by descriptor); EAGLE's tree verify and tree draft steps on
# a Gemma-2 target take its TREE instantiations
EXTEND_ALIGNED_256_KERNEL = register(CudaKernel(
    name="rpa_extend_aligned_256",
    source="csrc/rpa_extend.cu",
    symbol="rpa_extend_aligned_256",
    argtypes=_ARGTYPES,
    replaces="semi_pd_tpu/ops/attention/ragged_paged_attention.py:59 _rpa_kernel "
             "(GQA branch, head_dim 256)",
    defines=(f"EXTEND_QBLK={EXTEND_Q_BLOCK}", *aligned_defines(256)),
))

# The TPU kernel's MLA branch upcasts q and the latent rows to float32 and
# keeps P in float32 (RPA_P_F32)
EXTEND_MLA_KERNEL = register(CudaKernel(
    name="rpa_extend_mla",
    source="csrc/rpa_extend_mla.cu",
    symbol="rpa_extend_mla",
    argtypes=_ARGTYPES,
    replaces="semi_pd_tpu/ops/attention/ragged_paged_attention.py:59 _rpa_kernel "
             "(MLA v_dim branch)",
    defines=(f"EXTEND_QBLK={EXTEND_Q_BLOCK}", "RPA_P_F32"),
))

# MiniCPM3's latent geometry (rpa_common.LATENT_BUILDS); NextN's tree
# verify and tree draft steps on a MiniCPM3 target take its TREE
# instantiations
EXTEND_MLA_288_KERNEL = register(CudaKernel(
    name="rpa_extend_mla_288",
    source="csrc/rpa_extend_mla.cu",
    symbol="rpa_extend_mla_288",
    argtypes=_ARGTYPES,
    replaces="semi_pd_tpu/ops/attention/ragged_paged_attention.py:59 _rpa_kernel "
             "(MLA v_dim branch, latent 288 / v_dim 256)",
    defines=(f"EXTEND_QBLK={EXTEND_Q_BLOCK}", "RPA_P_F32", *latent_defines(288)),
))
# the latent extends by latent width
EXTEND_MLA_KERNELS = {576: EXTEND_MLA_KERNEL, 288: EXTEND_MLA_288_KERNEL}

EXTEND_MERGED_KERNEL = register(CudaKernel(
    name="rpa_extend_merged",
    source="csrc/rpa_extend.cu",
    symbol="rpa_extend_merged",
    argtypes=_ARGTYPES,
    replaces="semi_pd_tpu/ops/attention/ragged_paged_attention.py:300 _rpa_kernel_merged "
             "(extend)",
    defines=(f"EXTEND_QBLK={EXTEND_Q_BLOCK}", *MERGED_DEFINES),
))

# The extend kernel of each kernel family of the 5D and the latent pool
# (rpa_common.kernel_family; rpa_common.pick_kernel)
EXTEND_KERNELS = {"aligned": {128: EXTEND_ALIGNED_KERNEL, 256: EXTEND_ALIGNED_256_KERNEL},
                  "merged": EXTEND_MERGED_KERNEL, "latent": EXTEND_MLA_KERNELS}


def _decodes(q, page_table, spec_anc) -> bool:
    """Whether a batch takes the pool's decode: decode-shaped (T == B) and
    no speculation tree (a tree's draft step is decode-shaped and takes the
    extend, as in JAX)."""
    return q.shape[0] == page_table.shape[0] and spec_anc is None


def _streams(stream: bool, kv_cache, sliding_window) -> bool:
    """Whether a decode batch takes the streaming decode: asked for, and
    none of the JAX routing's exceptions (the 5D pool below head_dim 128
    keeps its merged kernel, :548; a batch with ``spec_anc`` is no decode,
    ``_decodes``). A sliding window keeps the packed decode here: the
    chunked router does the same (:1086-1110), while the 5D router skips
    both its packed (:569-571) and its stream branch (:589-595) for such a
    batch and runs _rpa_kernel, at QBLK 16; both compute the same
    function, so this routing stays (Gemma-2's windowed layers take the
    packed decode under ``stream``, its full ones the stream)."""
    return stream and not sliding_window and kernel_family(kv_cache) != "merged"


def ragged_paged_attention_chunked(
    q, kv_cache, layer_idx, page_table, kv_lens, meta, *, page_size,
    num_kv_heads, head_dim, scale, logit_cap=None, sliding_window=None,
    spec_anc=None, win_base=None, stream=False,
) -> torch.Tensor:
    """Attention of q [T, Hq, D] over the chunked pool [L, S, CT, 128]:
    T == B batches without ``spec_anc`` take the decode kernel (with
    ``stream`` the streaming decode), all others the extend kernel."""
    kw = dict(page_size=page_size, num_kv_heads=num_kv_heads, head_dim=head_dim,
              scale=scale, logit_cap=logit_cap, sliding_window=sliding_window)
    if _decodes(q, page_table, spec_anc):
        check_spec(None, win_base, page_table.shape[0])
        if _streams(stream, kv_cache, sliding_window):
            return ragged_paged_attention_chunked_stream(
                q, kv_cache, layer_idx, page_table, kv_lens, page_size=page_size,
                num_kv_heads=num_kv_heads, head_dim=head_dim, scale=scale,
                logit_cap=logit_cap)
        return ragged_paged_attention_chunked_packed(
            q, kv_cache, layer_idx, page_table, kv_lens, **kw)
    return ragged_paged_attention_chunked_extend(
        q, kv_cache, layer_idx, page_table, kv_lens, meta, spec_anc=spec_anc,
        win_base=win_base, **kw)


def ragged_paged_attention_chunked_plain(
    q, kv_cache, layer_idx, page_table, kv_lens, meta, *, page_size,
    num_kv_heads, head_dim, scale, logit_cap=None, sliding_window=None,
    spec_anc=None, win_base=None,
) -> torch.Tensor:
    """The same routing over the two plain versions, on any device (used to
    hold the kernels to their plain versions at full width)."""
    kw = dict(page_size=page_size, num_kv_heads=num_kv_heads, head_dim=head_dim,
              scale=scale, logit_cap=logit_cap, sliding_window=sliding_window)
    check_spec(spec_anc, win_base, page_table.shape[0])
    if _decodes(q, page_table, spec_anc):
        return decode_attention_plain(q, kv_cache, layer_idx, page_table, kv_lens, **kw)
    return extend_attention_plain(q, kv_cache, layer_idx, page_table, kv_lens, meta,
                                  spec_anc=spec_anc, win_base=win_base, **kw)


def ragged_paged_attention(
    q: torch.Tensor,  # [T, Hq, D] flat ragged
    kv_cache: torch.Tensor,  # [L, 2, S, Hkv, D], or [L, 1, S, 1, Dlat] with v_dim
    layer_idx: int,
    page_table: torch.Tensor,  # [B, maxP] int32
    kv_lens: torch.Tensor,  # [B] int32
    meta,  # runtime.forward_batch.AttnMeta
    *,
    page_size: int,
    scale: float,
    logit_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
    v_dim: Optional[int] = None,
    spec_anc: Optional[tuple] = None,
    win_base: Optional[torch.Tensor] = None,
    stream: bool = False,
    alibi_slopes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention of q [T, Hq, D] over the aligned pool (Hkv and D from its
    shape), or with ``v_dim`` over the MLA latent pool (output [T, Hq,
    v_dim]): T == B batches without ``spec_anc`` take the pool's decode
    kernel (with ``stream`` its streaming decode, except below head_dim
    128), all others, a tree's decode-shaped draft steps included, its
    extend kernel. ``alibi_slopes`` (float32 [Hq]): ALiBi's bias, in the
    decode's and the extend's ALiBi instantiations; not with ``stream`` or
    ``spec_anc`` (ROADMAP B9.6)."""
    kw = dict(page_size=page_size, scale=scale, logit_cap=logit_cap,
              sliding_window=sliding_window, v_dim=v_dim)
    if alibi_slopes is not None:
        kw["alibi_slopes"] = alibi_slopes
    if _decodes(q, page_table, spec_anc):
        check_spec(None, win_base, page_table.shape[0])
        if _streams(stream, kv_cache, sliding_window):
            if alibi_slopes is not None:
                raise NotImplementedError("ALiBi with decode_stream: the streaming decodes "
                                          "take no slopes (ROADMAP B9.6)")
            return ragged_paged_attention_stream(
                q, kv_cache, layer_idx, page_table, kv_lens, page_size=page_size,
                scale=scale, logit_cap=logit_cap, v_dim=v_dim)
        return ragged_paged_attention_packed(q, kv_cache, layer_idx, page_table,
                                             kv_lens, **kw)
    return ragged_paged_attention_extend(q, kv_cache, layer_idx, page_table, kv_lens,
                                         meta, spec_anc=spec_anc, win_base=win_base, **kw)


def ragged_paged_attention_plain(
    q, kv_cache, layer_idx, page_table, kv_lens, meta, *, page_size, scale,
    logit_cap=None, sliding_window=None, v_dim=None, spec_anc=None, win_base=None,
    alibi_slopes=None,
) -> torch.Tensor:
    """The aligned and the latent pool's routing over the two plain
    versions, on any device."""
    kw = dict(page_size=page_size, scale=scale, logit_cap=logit_cap,
              sliding_window=sliding_window, v_dim=v_dim, alibi_slopes=alibi_slopes)
    check_spec(spec_anc, win_base, page_table.shape[0])
    if _decodes(q, page_table, spec_anc):
        return ragged_paged_attention_packed_plain(q, kv_cache, layer_idx, page_table,
                                                   kv_lens, **kw)
    return ragged_paged_attention_extend_plain(q, kv_cache, layer_idx, page_table,
                                               kv_lens, meta, spec_anc=spec_anc,
                                               win_base=win_base, **kw)


def _extend(kernel, q, kv_cache, layer_idx, page_table, kv_lens, meta, *, page_size,
            num_kv_heads, head_dim, scale, logit_cap, sliding_window, v_dim=None,
            spec_anc=None, win_base=None, alibi_slopes=None):
    check_pool_args(q, kv_cache, layer_idx, page_table, kv_lens, num_kv_heads, head_dim,
                    v_dim)
    check_spec(spec_anc, win_base, page_table.shape[0])
    check_alibi(alibi_slopes, q, spec_anc, v_dim)
    kw = dict(page_size=page_size, num_kv_heads=num_kv_heads, head_dim=head_dim,
              scale=scale, logit_cap=logit_cap, sliding_window=sliding_window, v_dim=v_dim)
    if q.device.type == "cpu":
        return extend_attention_plain(q, kv_cache, layer_idx, page_table, kv_lens, meta,
                                      spec_anc=spec_anc, win_base=win_base,
                                      alibi_slopes=alibi_slopes, **kw)
    if q.device.type != "cuda":
        raise RuntimeError(f"no extend kernel for device {q.device}")
    if alibi_slopes is not None:
        kernel = alibi_build(kernel, EXTEND_ALIBI)
    ints = (meta.q_lens, meta.q_start, meta.block_seq, meta.block_row, meta.block_qofs)
    if any(a.dtype != torch.int32 for a in ints):
        raise ValueError("work-list arrays must be int32")
    check_cuda(q, kv_cache, page_table, kv_lens, *ints,
               *(() if win_base is None else (win_base,)), v_dim=v_dim)
    T, Hq, D = q.shape
    Dv = v_dim or D
    k_ptr, v_ptr, row_stride = kv_planes(kv_cache, layer_idx, num_kv_heads, D)
    # zeros: bucket-padding rows stay finite when their K/V are later
    # scattered into the dump page
    out = q.new_zeros((T, Hq, Dv))
    args = [q.data_ptr(), k_ptr, v_ptr, page_table.data_ptr(), kv_lens.data_ptr(),
            *[a.data_ptr() for a in ints], out.data_ptr(), meta.block_seq.shape[0], Hq,
            num_kv_heads, D, row_stride, page_table.shape[1], page_size, float(scale),
            float(logit_cap or 0.0), int(sliding_window or 0), TYPE_CODES[q.dtype],
            TYPE_CODES[kv_cache.dtype]]
    # the tree's masks cross as a host array (kept alive through the call);
    # W == 0 is no tree
    if spec_anc:
        anc = (ctypes.c_int * MAX_TREE_NODES)(*spec_anc)
        args += [len(spec_anc), ctypes.addressof(anc), win_base.data_ptr()]
    else:
        args += [0, None, None]
    args.append(None if alibi_slopes is None else alibi_slopes.data_ptr())
    kernel.launch(*args, cuda_stream_ptr(q.device))
    return out


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
    spec_anc: Optional[tuple] = None,
    win_base: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Extend attention over the chunked pool (with ``spec_anc`` /
    ``win_base`` a speculation tree's mask); rows no work-list entry owns
    stay 0."""
    return _extend(EXTEND_KERNEL, q, kv_cache, layer_idx, page_table, kv_lens, meta,
                   page_size=page_size, num_kv_heads=num_kv_heads, head_dim=head_dim,
                   scale=scale, logit_cap=logit_cap, sliding_window=sliding_window,
                   spec_anc=spec_anc, win_base=win_base)


def ragged_paged_attention_extend(
    q: torch.Tensor,  # [T, Hq, D] flat new tokens (D = Dlat with v_dim)
    kv_cache: torch.Tensor,  # [L, 2, S, Hkv, D], or [L, 1, S, 1, Dlat] with v_dim
    layer_idx: int,
    page_table: torch.Tensor,  # [B, maxP] int32
    kv_lens: torch.Tensor,  # [B] int32
    meta,  # runtime.forward_batch.AttnMeta
    *,
    page_size: int,
    scale: float,
    logit_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
    v_dim: Optional[int] = None,
    spec_anc: Optional[tuple] = None,
    win_base: Optional[torch.Tensor] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Extend attention over the aligned pool (the build of its head_dim,
    128 or 256; the merged kernel below 128; with ``spec_anc`` /
    ``win_base`` a speculation tree's mask; with ``alibi_slopes`` ALiBi's
    bias, the aligned head_dim-128 build's ALiBi instantiation on the
    card), or with ``v_dim`` over the MLA latent pool (output [T, Hq,
    v_dim]; the tree's mask there too); rows no work-list entry owns stay
    0."""
    Hkv, D = pool_heads(kv_cache)
    return _extend(pick_kernel(EXTEND_KERNELS, kv_cache), q, kv_cache, layer_idx,
                   page_table, kv_lens, meta, page_size=page_size, num_kv_heads=Hkv,
                   head_dim=D, scale=scale, logit_cap=logit_cap,
                   sliding_window=sliding_window, v_dim=v_dim, spec_anc=spec_anc,
                   win_base=win_base, alibi_slopes=alibi_slopes)


def ragged_paged_attention_extend_plain(
    q, kv_cache, layer_idx, page_table, kv_lens, meta, *, page_size, scale,
    logit_cap=None, sliding_window=None, v_dim=None, spec_anc=None, win_base=None,
    alibi_slopes=None,
) -> torch.Tensor:
    """Plain version of the aligned, the merged and the MLA extend
    kernels."""
    Hkv, D = pool_heads(kv_cache)
    return extend_attention_plain(q, kv_cache, layer_idx, page_table, kv_lens, meta,
                                  page_size=page_size, num_kv_heads=Hkv, head_dim=D,
                                  scale=scale, logit_cap=logit_cap,
                                  sliding_window=sliding_window, v_dim=v_dim,
                                  spec_anc=spec_anc, win_base=win_base,
                                  alibi_slopes=alibi_slopes)


def extend_attention_plain(
    q, kv_cache, layer_idx, page_table, kv_lens, meta, *, page_size,
    num_kv_heads, head_dim, scale, logit_cap=None, sliding_window=None, v_dim=None,
    spec_anc=None, win_base=None, alibi_slopes=None,
) -> torch.Tensor:
    """Plain version of the extend kernels, on any pool: a loop over the
    work-list entries, each gathering its request's pages up to its last
    row's position, then a causal float32 softmax over them (with
    ``spec_anc`` refined by the speculation tree's ancestor masks inside the
    request's window from ``win_base``; with ``alibi_slopes`` ALiBi's bias
    by each row's position, after the scale and the softcap)."""
    T, Hq, D = q.shape
    Hkv = num_kv_heads
    G = Hq // Hkv
    Dv = v_dim or D
    k_layer, v_layer = layer_kv(kv_cache, layer_idx, Hkv, D, v_dim)
    seq, row, qofs = (meta.block_seq.tolist(), meta.block_row.tolist(),
                      meta.block_qofs.tolist())
    q_lens, q_start, lens = (meta.q_lens.tolist(), meta.q_start.tolist(),
                             kv_lens.tolist())
    cap = page_table.shape[1] * page_size
    bases = win_base.tolist() if spec_anc is not None else None
    out = q.new_zeros((T, Hq, Dv))
    for i, b in enumerate(seq):
        if b < 0:
            continue
        n_rows = min(q_lens[b] - qofs[i], EXTEND_Q_BLOCK)
        q_abs = q_start[b] + qofs[i] + torch.arange(n_rows, device=q.device)
        n = min(lens[b], q_start[b] + qofs[i] + n_rows, cap)
        if n <= 0:
            continue
        k, v = gather_kv(k_layer, v_layer, page_table[b], n, page_size)
        r0 = row[i]
        qb = q[r0 : r0 + n_rows].float().reshape(n_rows, Hkv, G, D)
        s = torch.einsum("rhgd,nhd->rhgn", qb, k) * scale
        if logit_cap:
            s = logit_cap * torch.tanh(s / logit_cap)
        pos = torch.arange(n, device=q.device)[None, :]
        if alibi_slopes is not None:
            s = s + alibi_bias(alibi_slopes, Hkv, q_abs[:, None], pos)
        valid = pos <= q_abs[:, None]
        if sliding_window:
            valid &= pos > q_abs[:, None] - sliding_window
        if spec_anc is not None:
            valid = spec_tree_mask(valid, spec_anc, bases[b], q_abs[:, None], pos)
        s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
        p = torch.softmax(s, dim=-1)
        p = torch.where(valid.any(dim=-1)[:, None, None, None], p,
                        torch.zeros((), device=q.device))
        o = torch.einsum("rhgn,nhd->rhgd", p, v).reshape(n_rows, Hq, Dv)
        out[r0 : r0 + n_rows] = o.to(q.dtype)
    return out

