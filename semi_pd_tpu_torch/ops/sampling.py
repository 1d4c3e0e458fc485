"""Batched sampling on the device (port of semi_pd_tpu/ops/sampling.py).

Exact top-k (kth-value threshold), top-p (sorted cumulative mass) and min-p
(max-prob threshold); the categorical draw is Gumbel-argmax on the masked
logits with noise from an explicit ``torch.Generator``. A generator cannot
reproduce ``jax.random``'s streams, so only greedy rows are comparable
token for token with the JAX package.

On the card a decode step's sampling is captured in its CUDA graph
(runtime/cuda_graph_runner.py): the runner's generator is registered with
every graph, so each replay draws new numbers and advances it as an eager
step does, and ``all_greedy`` is part of the graph's key.

Penalties, top-k logprobs and grammar vocab masks are ROADMAP A10.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SamplingArrays(NamedTuple):
    """Per-request sampling parameters, batch-aligned [B] (numpy on the host
    side of ``HostBatch``, tensors on the device side)."""

    temperature: object  # [B] f32; 0 => greedy
    top_k: object  # [B] i32; 0 or >=V => disabled
    top_p: object  # [B] f32; 1.0 => disabled
    min_p: object  # [B] f32; 0.0 => disabled
    presence_penalty: object  # [B] f32
    frequency_penalty: object  # [B] f32
    repetition_penalty: object  # [B] f32; 1.0 => disabled


def sample(
    logits: torch.Tensor,  # [B, V] any float dtype
    params: SamplingArrays,
    generator: torch.Generator,
    all_greedy: bool = False,
) -> torch.Tensor:
    """Returns sampled token ids [B] int32. ``all_greedy`` (known on the
    host from the packed batch) skips the sort/threshold work when every row
    is greedy; the result is the same argmax either way."""
    logits = logits.float()
    B, V = logits.shape
    greedy_ids = torch.argmax(logits, dim=-1).to(torch.int32)
    if all_greedy:
        return greedy_ids

    temp = torch.clamp(params.temperature, min=1e-6)[:, None]
    scaled = logits / temp

    # top-k: threshold at the kth largest logit
    k_disabled = (params.top_k <= 0) | (params.top_k >= V)
    k_eff = torch.clamp(params.top_k, 1, V).long()
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    kth_val = torch.gather(sorted_desc, 1, (k_eff - 1)[:, None])
    keep_k = (scaled >= kth_val) | k_disabled[:, None]

    # top-p over the sorted distribution; keep the smallest set whose mass
    # reaches top_p (rank 0 always kept)
    probs_sorted = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs_sorted, dim=-1)
    first = torch.argmax((cum >= params.top_p[:, None]).to(torch.int32), dim=-1)
    cut_val = torch.gather(sorted_desc, 1, first[:, None])
    keep_p = (scaled >= cut_val) | (params.top_p >= 1.0)[:, None]

    # min-p: prob >= min_p * max_prob
    max_logit = scaled.max(dim=-1, keepdim=True).values
    probs = torch.exp(scaled - max_logit)
    norm = probs.sum(dim=-1, keepdim=True)
    keep_m = (probs / norm) >= (params.min_p[:, None] * (1.0 / norm))
    keep_m = keep_m | (params.min_p <= 0.0)[:, None]

    masked = torch.where(keep_k & keep_p & keep_m, scaled,
                         torch.full_like(scaled, float("-inf")))
    u = torch.rand(masked.shape, generator=generator, device=masked.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    sampled = torch.argmax(masked + gumbel, dim=-1).to(torch.int32)
    return torch.where(params.temperature <= 0.0, greedy_ids, sampled)


def compute_logprobs(logits: torch.Tensor, token_ids: torch.Tensor) -> torch.Tensor:
    """Log-prob of chosen tokens: logits [B, V], token_ids [B] -> [B] f32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(logp, 1, token_ids.long()[:, None])[:, 0]
