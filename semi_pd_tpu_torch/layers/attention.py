"""Attention layer: KV-pool write + kernel dispatch (port of
semi_pd_tpu/layers/attention.py::paged_attention for the chunked and the
aligned (5D) pool, and ::paged_attention_mla for the MLA latent pool).

Every model's attention calls ``paged_attention`` (MLA models
``paged_attention_mla``), which (1) scatters the step's fresh K/V (the
latent rows) into the shared pool at the scheduler-assigned slots, in
place (the JAX package's functional ``.at[].set``), and (2) runs the
ragged paged attention of the pool's layout over it: the CUDA kernels for
CUDA tensors, their plain versions for CPU tensors
(ops/attention/ragged_paged_attention.py). Per-layer fp8-KV scales
(``fb.kv_scales``) are applied outside the kernels by linearity, as the JAX
layer does. A speculation tree's masks travel on the batch (``fb.spec_anc``
with ``fb.win_base``; the JAX layer's ``spec_tree_context`` module global):
``paged_attention`` and ``paged_attention_mla`` pass them to the routing,
which sends such a batch to the pool's extend kernel.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from semi_pd_tpu_torch.ops.attention.ragged_paged_attention import (
    ragged_paged_attention,
    ragged_paged_attention_chunked,
    ragged_paged_attention_chunked_plain,
    ragged_paged_attention_plain,
)
from semi_pd_tpu_torch.ops.attention.rpa_common import pool_layout


def write_kv(kv_cache: torch.Tensor, layer_idx: int, out_slots: torch.Tensor,
             k_new: torch.Tensor, v_new: torch.Tensor) -> None:
    """Scatter K and V of T tokens into their slots of layer ``layer_idx``:
    one slot row of the chunked pool [L, S, CT, 128] (K chunks, then V
    chunks), or the K and V planes of the 5D pool [L, 2, S, Hkv, D] (at
    head_dim 128 or below).
    Padded tokens carry slots in the dump page. Into an fp8 pool the cast
    rounds to nearest as JAX's does, but saturates above 448 in magnitude
    where JAX gives NaN (ROADMAP C5)."""
    T, Hkv, D = k_new.shape
    slots = out_slots.long()
    if pool_layout(kv_cache) == "chunked":
        val = torch.cat([k_new.reshape(T, Hkv * D // 128, 128),
                         v_new.reshape(T, Hkv * D // 128, 128)], dim=1)
        kv_cache[layer_idx][slots] = val.to(kv_cache.dtype)
    else:
        kv_cache[layer_idx, 0][slots] = k_new.to(kv_cache.dtype)
        kv_cache[layer_idx, 1][slots] = v_new.to(kv_cache.dtype)


def pool_attention(kv_cache: torch.Tensor, plain: bool = False, stream: bool = False):
    """The attention function of the pool's layout: the routing to the
    kernels, or with ``plain`` the same routing over their plain versions
    on any device (to hold the kernels to them at full width). The aligned
    and the latent pool share one routing function (``v_dim`` selects the
    latent pool's kernels). ``stream``: decode batches take the pool's
    streaming decode (ServerArgs.decode_stream, the JAX package's
    RPA_DECODE_STREAM=1), under the JAX routing's exceptions; its plain
    version is the decode's, so ``plain`` ignores it."""
    if pool_layout(kv_cache) == "chunked":
        fn = ragged_paged_attention_chunked_plain if plain else ragged_paged_attention_chunked
    else:
        fn = ragged_paged_attention_plain if plain else ragged_paged_attention
    return functools.partial(fn, stream=True) if stream and not plain else fn


def paged_attention(
    q: torch.Tensor,  # [T, Hq, D]
    k_new: torch.Tensor,  # [T, Hkv, D]
    v_new: torch.Tensor,  # [T, Hkv, D]
    kv_cache: torch.Tensor,  # the whole pool, either layout, updated in place
    layer_idx: int,
    fb,  # runtime.forward_batch.ForwardArrays
    page_size: int,
    scale: float,
    logit_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
    attention=None,
    alibi_slopes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Returns attn_out [T, Hq, D]. ``attention`` is the function run over
    the pool after the write, with the signature of the pool layout's
    routing function; the default (None) is that routing, to the kernels.
    ``alibi_slopes`` (float32 [Hq], Baichuan2-13B's ALiBi) goes to the
    routing, which biases the scores with it (the JAX layer sends such a
    model to its reference attention, semi_pd_tpu/layers/attention.py:137;
    here the aligned head_dim-128 decode and extend have an ALiBi
    instantiation)."""
    # Per-layer fp8-KV scales: store k/k_s and v/v_s (so calibrated scales
    # use the fp8 range), read with q*k_s (logits exact: (q*k_s).(k/k_s) =
    # q.k) and out*v_s, in the JAX layer's order of casts
    v_s = None
    if fb.kv_scales is not None:
        k_s = fb.kv_scales[layer_idx, 0].float()
        v_s = fb.kv_scales[layer_idx, 1].float()
        k_new = (k_new.float() / k_s).to(k_new.dtype)
        v_new = (v_new.float() / v_s).to(v_new.dtype)
        q = (q.float() * k_s).to(q.dtype)
    T, Hkv, D = k_new.shape
    write_kv(kv_cache, layer_idx, fb.out_slots, k_new, v_new)
    # the chunked pool's functions take Hkv and D; the aligned pool's read
    # them from its shape
    heads = (dict(num_kv_heads=Hkv, head_dim=D)
             if pool_layout(kv_cache) == "chunked" else {})
    if fb.spec_anc is not None:  # a speculation tree's draft or verify step
        heads.update(spec_anc=fb.spec_anc, win_base=fb.win_base)
    if alibi_slopes is not None:
        heads["alibi_slopes"] = alibi_slopes
    out = (attention or pool_attention(kv_cache))(
        q.contiguous(), kv_cache, layer_idx, fb.page_table, fb.kv_lens,
        fb.attn_meta, page_size=page_size, scale=scale, logit_cap=logit_cap,
        sliding_window=sliding_window, **heads,
    )
    if v_s is not None:
        out = (out.float() * v_s).to(out.dtype)
    return out


def paged_attention_mla(
    q: torch.Tensor,  # [T, Hq, Dlat] = [q_absorbed | q_pe]
    latent_new: torch.Tensor,  # [T, Dlat] = [c_kv | k_pe] of this step's tokens
    kv_cache: torch.Tensor,  # the latent pool [L, 1, S, 1, Dpool], updated in place
    layer_idx: int,
    fb,  # runtime.forward_batch.ForwardArrays
    page_size: int,
    scale: float,
    v_dim: int,  # = kv_lora_rank; V is the latent prefix of K
    attention=None,
) -> torch.Tensor:
    """MLA (absorbed) attention over the latent pool: writes the step's
    latent rows at ``fb.out_slots`` (in the pool's dtype, fp8 included),
    then runs the latent pool's routing.
    Returns [T, Hq, v_dim]. The port's pool is exactly Dlat wide; q and the
    rows are zero-padded only if a caller's pool is wider (zeros on both
    sides leave the scores unchanged, and V is the prefix either way)."""
    pad = kv_cache.shape[-1] - q.shape[-1]
    if pad:
        q = torch.nn.functional.pad(q, (0, pad))
        latent_new = torch.nn.functional.pad(latent_new, (0, pad))
    # into an fp8 pool the cast saturates above 448 where JAX gives NaN
    # (ROADMAP C5), for the latent rows as for write_kv's K and V
    kv_cache[layer_idx, 0, fb.out_slots.long(), 0] = latent_new.to(kv_cache.dtype)
    # a speculation tree's draft or verify step (NextN's): the routing sends
    # it to the latent pool's extend with the tree's masks, a decode-shaped
    # draft step included; its work list starts at the slot-order positions
    # (``fb.mask_pos``, which the JAX layer passes to its reference)
    tree = ({} if fb.spec_anc is None
            else dict(spec_anc=fb.spec_anc, win_base=fb.win_base))
    return (attention or pool_attention(kv_cache))(
        q.contiguous(), kv_cache, layer_idx, fb.page_table, fb.kv_lens, fb.attn_meta,
        page_size=page_size, scale=scale, v_dim=v_dim, **tree)
