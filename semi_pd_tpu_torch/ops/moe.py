"""Mixture-of-Experts feed-forward: routing and the sort-by-expert grouped
product (port of semi_pd_tpu/ops/moe.py: ``route_topk`` and ``moe_ffn``).

The JAX package has no Pallas kernel here: it sorts the (token, expert)
rows by expert and runs ``jax.lax.ragged_dot``, an XLA grouped matmul. The
port does the same sort and hands the two grouped products to
``grouped_matmul``: on a CUDA device in bf16 one ``torch._grouped_mm`` call
per product, with the group ends as a device tensor (no host sync); on a
CUDA device in float32, where no grouped product exists, every row times
every expert in one batched product (``grouped_matmul_dense``, E times the
work, also without a host sync) up to DENSE_MAX_ELEMENTS of output, else
the plain version; on the CPU the plain version, a loop over experts that
reads the group sizes on the host once per product. The experts' row
counts are made on the device (``expert_counts``), so a decode step with
MoE layers never waits for the card and can be captured in a CUDA graph.

Routing: softmax top-k (DeepSeek-V2 "greedy"), sigmoid scoring with a
score-correction bias and grouped selection (DeepSeek-V3 noaux_tc, V2's
group_limited_greedy), optional renormalisation and routed scaling.

Quantized expert stacks (``expert_weights``' dict form: ``{"w": fp8 |
int8 [E, K, N], "ws": float32 [E, N]}``, or a ``QuantWeight`` holding it)
run in bf16 whatever the model's dtype, as JAX dequantizes them to bf16:
the gathered rows are cast to bf16 and both grouped products go to
``ops/quant/wo_gemm.py wo_gemm_experts`` (on the card the kernel, which
widens and scales each weight tile in shared memory; on the CPU the stack
dequantized, (w * ws) rounded to bf16, then the plain loop).

Not ported: expert parallelism (``moe_ffn_ep``), ROADMAP A15.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from semi_pd_tpu_torch.layers.linear import QuantWeight
from semi_pd_tpu_torch.ops.elementwise import silu_and_mul
from semi_pd_tpu_torch.ops.quant.wo_gemm import wo_gemm_experts, wo_gemm_experts_plain


def route_topk(
    router_logits: torch.Tensor,  # [T, E]
    top_k: int,
    *,
    scoring: str = "softmax",
    norm_topk_prob: bool = False,
    n_group: Optional[int] = None,
    topk_group: Optional[int] = None,
    routed_scaling_factor: float = 1.0,
    e_score_bias: Optional[torch.Tensor] = None,  # [E] deepseek-v3 gate bias
    group_score_func: str = "top2",  # "top2" (v3 noaux_tc) | "max" (v2 group_limited)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (weights [T, K] float32, expert_idx [T, K] int32)."""
    T, E = router_logits.shape
    logits = router_logits.float()
    scores = torch.sigmoid(logits) if scoring == "sigmoid" else torch.softmax(logits, dim=-1)
    select = scores if e_score_bias is None else scores + e_score_bias.float()[None, :]
    if n_group and topk_group and n_group > 1:
        gs = select.reshape(T, n_group, E // n_group)
        if group_score_func == "max":
            group_score = gs.max(dim=-1).values
        else:
            group_score = gs.topk(min(2, E // n_group), dim=-1).values.sum(dim=-1)
        thresh = group_score.topk(topk_group, dim=-1).values[:, -1:]
        # each group's verdict over its E // n_group experts (an expand, not
        # repeat_interleave: nothing to size on the host)
        keep = (group_score >= thresh)[:, :, None].expand(T, n_group, E // n_group)
        keep = keep.reshape(T, E)
        select = select.masked_fill(~keep, float("-inf"))
    idx = select.topk(top_k, dim=-1).indices
    w = scores.gather(1, idx)  # weights from the unbiased scores
    if norm_topk_prob:
        w = w / w.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    return w * routed_scaling_factor, idx.to(torch.int32)


def grouped_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                         group_sizes: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` [N, k], sorted by group, times their group's ``w[g]``
    [k, n]: a loop over groups (one host read of the sizes)."""
    out = x.new_empty((x.shape[0], w.shape[2]))
    o = 0
    for g, n in enumerate(group_sizes.tolist()):
        if n:
            out[o : o + n] = x[o : o + n] @ w[g]
        o += n
    return out


# the most output elements (experts x rows x width) grouped_matmul_dense
# makes: 1 GiB in float32, above a decode step of DeepSeek-V2-Lite's 64
# experts at 64 requests (64 x 384 x 2816)
DENSE_MAX_ELEMENTS = 1 << 28


def grouped_matmul_dense(x: torch.Tensor, w: torch.Tensor,
                         group_sizes: torch.Tensor) -> torch.Tensor:
    """The plain version's result from one batched product of every row
    with every group's ``w[g]``, each row keeping its own group's: E times
    the work, and nothing read on the host."""
    N, n = x.shape[0], w.shape[2]
    ends = torch.cumsum(group_sizes, dim=0)
    group_of = torch.searchsorted(ends, torch.arange(N, device=x.device), right=True)
    full = torch.matmul(x[None], w)  # [E, N, n]
    return full.gather(0, group_of[None, :, None].expand(1, N, n))[0]


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   group_sizes: torch.Tensor) -> torch.Tensor:
    """``jax.lax.ragged_dot(x, w, group_sizes)``: ``torch._grouped_mm`` for
    bf16 on a CUDA device, ``grouped_matmul_dense`` for other dtypes there
    (up to DENSE_MAX_ELEMENTS), the plain loop otherwise."""
    if x.is_cuda and x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16:
        offs = torch.cumsum(group_sizes, dim=0).to(torch.int32)
        return torch._grouped_mm(x, w, offs=offs)
    if x.is_cuda and w.shape[0] * x.shape[0] * w.shape[2] <= DENSE_MAX_ELEMENTS:
        return grouped_matmul_dense(x, w, group_sizes)
    return grouped_matmul_plain(x, w, group_sizes)


def expert_counts(flat_idx: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Rows per expert, ``jnp.bincount(flat_idx, length=num_experts)``, as
    int64 [num_experts] made on the device: ``torch.bincount`` reads its
    input's max back to the host, a sync on a CUDA tensor."""
    counts = torch.zeros(num_experts, dtype=torch.int64, device=flat_idx.device)
    return counts.scatter_add_(0, flat_idx.long(), torch.ones_like(flat_idx, dtype=torch.int64))


def expert_stack(w):
    """An expert stack as ``moe_ffn`` takes it: a tensor, or a quantized
    stack's leaves {"w", "ws"} (from a dict or a ``QuantWeight``)."""
    return w.leaves() if isinstance(w, QuantWeight) else w


def _grouped(x: torch.Tensor, w, group_sizes: torch.Tensor, matmul) -> torch.Tensor:
    """One grouped product: a quantized stack through ``wo_gemm_experts``
    (its plain version where ``matmul`` is the plain loop), else ``matmul``."""
    if isinstance(w, dict):
        fn = wo_gemm_experts_plain if matmul is grouped_matmul_plain else wo_gemm_experts
        return fn(x, w["w"], w["ws"], group_sizes)
    return matmul(x, w, group_sizes)


def moe_ffn(
    x: torch.Tensor,  # [T, d]
    gate_up,  # [E, d, 2f] (or a quantized stack: expert_stack)
    down,  # [E, f, d]
    weights: torch.Tensor,  # [T, K] float32 routing weights
    expert_idx: torch.Tensor,  # [T, K] int32
    matmul=grouped_matmul,
    act=silu_and_mul,  # the gated activation over [.., 2f] (Grok-1: gelu_and_mul)
) -> torch.Tensor:
    """Sort-by-expert grouped MoE forward with gated ``act`` (SiLU unless
    the caller passes another), [T, d] -> [T, d],
    in the JAX order of casts: rows gathered in the experts' dtype (bf16
    for a quantized stack), both products and the weighted sum in that
    dtype, cast back to x's.
    ``matmul`` is the grouped product (``grouped_matmul_plain`` holds the
    CUDA path to the plain loop).

    The weighted rows go back to (token, k) order and each token's K rows
    are summed in one reduction, so a token's result is the same from run
    to run; a scatter-add (JAX's ``.at[].add``, torch's ``index_add_``)
    adds with atomics on a CUDA device, in an order that varies."""
    gate_up, down = expert_stack(gate_up), expert_stack(down)
    T, d = x.shape
    quant = isinstance(gate_up, dict)
    E = (gate_up["w"] if quant else gate_up).shape[0]
    K = weights.shape[1]
    flat = expert_idx.reshape(T * K).long()
    order = torch.argsort(flat, stable=True)
    token_of = order // K  # source token of each sorted row
    group_sizes = expert_counts(flat, E)
    rows_dtype = torch.bfloat16 if quant else gate_up.dtype
    h = act(_grouped(x[token_of].to(rows_dtype), gate_up, group_sizes, matmul))
    out_rows = _grouped(h, down, group_sizes, matmul)  # [T*K, d], sorted by expert
    w_rows = weights.reshape(T * K)[order].to(out_rows.dtype)
    rows = torch.empty_like(out_rows)
    rows[order] = out_rows * w_rows[:, None]  # row t*K + k: token t's k-th expert
    return rows.view(T, K, d).sum(dim=1).to(x.dtype)
