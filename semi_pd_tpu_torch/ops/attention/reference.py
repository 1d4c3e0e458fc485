"""Reference ragged paged attention in plain torch (port of
semi_pd_tpu/ops/attention/reference.py).

The oracle every attention kernel of the port is held against. Queries for
all requests are concatenated into a flat [T, Hq, D]; per-token arrays map
each query row to its request and absolute position; KV is read from the
paged pool through the page table. Query token t (request r = q_req_idx[t],
position p = q_pos[t]) attends to KV positions j of request r with j <= p
and j < kv_lens[r] (and j > p - sliding_window when a window is set).
With a speculation tree (``spec_anc`` / ``win_base``), ``q_pos`` holds
slot-order positions (the JAX layer passes ``fb.mask_pos``) and positions
inside a request's window also need the query row's ancestor bit.
"""

from __future__ import annotations

from typing import Optional

import torch


def chunked_to_5d(kv_cache: torch.Tensor, num_kv_heads: int, head_dim: int) -> torch.Tensor:
    """View of the chunked pool [L, S, CT, 128] (K chunks, then V chunks per
    slot row) as the 5D pool [L, 2, S, Hkv, D] the reference reads, as
    semi_pd_tpu/layers/attention.py:116-119 does."""
    L, S, CT, _ = kv_cache.shape
    return kv_cache.reshape(L, S, 2, num_kv_heads, head_dim).transpose(1, 2)


def ragged_paged_attention_reference(
    q: torch.Tensor,  # [T, Hq, D]
    kv_cache: torch.Tensor,  # [L, 2, S, Hkv, D] (component: K=0, V=1), or
                             # the latent pool [L, 1, S, 1, Dlat] with v_dim
    layer_idx: int,
    page_table: torch.Tensor,  # [B, maxP] int32 page ids
    q_req_idx: torch.Tensor,  # [T] i32 (padding rows -> row 0, masked out)
    q_pos: torch.Tensor,  # [T] i32 absolute position of query token
    kv_lens: torch.Tensor,  # [B] i32 total kv length per request (incl. new)
    page_size: int,
    scale: float,
    logit_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
    v_dim: Optional[int] = None,
    spec_anc: Optional[tuple] = None,
    win_base: Optional[torch.Tensor] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``v_dim``: MLA mode. The pool has one component, the latent row
    [c_kv | k_pe]; V is its first v_dim elements and the output is
    [T, Hq, v_dim].

    ``spec_anc``: static speculation-tree ancestor masks (one int per window
    node; speculative/tree.py) with ``win_base`` [B], the window start of
    each request. ``q_pos`` must then be SLOT-ORDER positions (window node
    index + win_base), and KV positions inside the window [win_base,
    win_base + W) also need the matching ancestor bit. A row's node index
    is clipped into the window, as the JAX reference does."""
    if alibi_slopes is not None:
        raise NotImplementedError("ALiBi attention is ROADMAP A14")
    T, Hq, D = q.shape
    Hkv = kv_cache.shape[3]
    B, maxP = page_table.shape
    max_kv = maxP * page_size
    group = Hq // Hkv

    slot_ids = (
        page_table.long()[:, :, None] * page_size
        + torch.arange(page_size, device=q.device)[None, None, :]
    ).reshape(B, max_kv)
    k = kv_cache[layer_idx, 0][slot_ids].float()  # [B, max_kv, Hkv, D]
    if v_dim is not None:
        v = k[..., :v_dim]
    else:
        v = kv_cache[layer_idx, 1][slot_ids].float()
    Dv = v.shape[-1]
    ri = q_req_idx.long()
    k_t = k[ri]  # [T, max_kv, Hkv, D]
    v_t = v[ri]

    qf = q.float().reshape(T, Hkv, group, D)
    scores = torch.einsum("thgd,tkhd->thgk", qf, k_t) * scale
    if logit_cap:
        scores = logit_cap * torch.tanh(scores / logit_cap)
    kv_pos = torch.arange(max_kv, device=q.device)[None, :]
    qp = q_pos.long()[:, None]
    valid = (kv_pos <= qp) & (kv_pos < kv_lens.long()[ri][:, None])
    if sliding_window is not None and sliding_window > 0:
        valid &= kv_pos > (qp - sliding_window)
    if spec_anc is not None and win_base is not None:
        W = len(spec_anc)
        anc = torch.as_tensor([int(a) & 0xFFFFFFFF for a in spec_anc], dtype=torch.int64,
                              device=q.device)
        wb = win_base.long()[ri][:, None]  # [T, 1]
        bits = anc[(qp - wb).clamp(0, W - 1)]  # [T, 1]: the row's node
        win_kv = kv_pos - wb  # [T, max_kv]
        in_win = (win_kv >= 0) & (win_kv < W)
        tree_ok = ((bits >> win_kv.clamp(0, 31)) & 1) == 1
        valid &= torch.where(in_win, tree_ok, torch.ones_like(tree_ok))
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    # fully-masked (padding) rows give NaN from softmax over -inf; zero them
    probs = torch.where(valid.any(dim=-1)[:, None, None, None], probs,
                        torch.zeros((), device=q.device))
    out = torch.einsum("thgk,tkhd->thgd", probs, v_t)
    return out.reshape(T, Hq, Dv).to(q.dtype)
