"""Batched sampling on the device (port of semi_pd_tpu/ops/sampling.py).

Exact top-k (kth-value threshold), top-p (sorted cumulative mass) and min-p
(max-prob threshold); the categorical draw is Gumbel-argmax on the masked
logits with noise from an explicit ``torch.Generator``. Before any of it,
presence / frequency / repetition penalties from a compact per-request
token histogram (``PenaltyArrays``, scattered into dense [B, V] counts on
the device, as the JAX sampler does), then a grammar's bool vocab mask or a
float32 additive bias (custom logit processors, grammar bans folded in as
-inf). ``top_logprobs`` gives the k most likely next tokens' log-probs. A generator cannot
reproduce ``jax.random``'s streams, so only greedy rows are comparable
token for token with the JAX package.

On the card a decode step's sampling is captured in its CUDA graph
(runtime/cuda_graph_runner.py): the runner's generator is registered with
every graph, so each replay draws new numbers and advances it as an eager
step does, and ``all_greedy`` is part of the graph's key, as are the
mask's kind, the penalties and the top-k k (runtime/cuda_graph_runner.py
``StepVariant``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


# the penalty histogram's width: distinct tokens a penalized request carries
# (generated tokens first; prompt-only entries beyond it are dropped)
PENALTY_HIST = 512


class PenaltyArrays(NamedTuple):
    """Compact per-request token histogram shipped with penalized batches:
    the dense counts are rebuilt on the device from (ids, counts), so the
    host never transfers [B, V]. ``hist_ids``: [B, H] int32 token ids (-1
    pad); ``hist_counts``: [B, H] int32 counts of that token among the
    generated tokens; ``hist_prompt``: [B, H] bool, the token appears in the
    prompt (the repetition penalty covers prompt tokens too). numpy on the
    host, tensors on the device."""

    hist_ids: object
    hist_counts: object
    hist_prompt: object


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


def apply_penalties(
    logits: torch.Tensor,  # [B, V] float32
    output_counts: torch.Tensor,  # [B, V] int32: counts of generated tokens
    prompt_mask: torch.Tensor,  # [B, V] bool: tokens present in the prompt
    p: SamplingArrays,
) -> torch.Tensor:
    occurred = (output_counts > 0) | prompt_mask
    rep = p.repetition_penalty[:, None]
    logits = torch.where(occurred, torch.where(logits > 0, logits / rep, logits * rep), logits)
    logits = logits - p.frequency_penalty[:, None] * output_counts.float()
    logits = logits - p.presence_penalty[:, None] * (output_counts > 0).float()
    return logits


def dense_penalty_counts(penalties: PenaltyArrays, B: int, V: int):
    """The histogram's dense (counts [B, V] int32, prompt mask [B, V]
    bool): padded entries (id -1) add 0 at id 0. Integer scatters, so the
    result does not depend on the order of the adds."""
    ids = penalties.hist_ids.long()
    valid = ids >= 0
    safe = ids.clamp_min(0)
    dev = ids.device
    counts = torch.zeros(B, V, dtype=torch.int32, device=dev).scatter_add_(
        1, safe, torch.where(valid, penalties.hist_counts.to(torch.int32), 0))
    prompt = torch.zeros(B, V, dtype=torch.int32, device=dev).scatter_reduce_(
        1, safe, (valid & penalties.hist_prompt.bool()).to(torch.int32), reduce="amax")
    return counts, prompt > 0


def sample(
    logits: torch.Tensor,  # [B, V] any float dtype
    params: SamplingArrays,
    generator: torch.Generator,
    all_greedy: bool = False,
    vocab_mask: Optional[torch.Tensor] = None,  # [B, V] bool, or float32 bias
    penalties: Optional[PenaltyArrays] = None,
) -> torch.Tensor:
    """Returns sampled token ids [B] int32. ``all_greedy`` (known on the
    host from the packed batch) skips the sort/threshold work when every row
    is greedy; the result is the same argmax either way. ``penalties`` are
    applied first, then ``vocab_mask``: a bool grammar mask (False bans the
    token) or a float32 additive bias (custom logit processors; grammar bans
    arrive folded in as -inf)."""
    logits = logits.float()
    B, V = logits.shape
    if penalties is not None:
        counts, prompt_mask = dense_penalty_counts(penalties, B, V)
        logits = apply_penalties(logits, counts, prompt_mask, params)
    if vocab_mask is not None:
        if vocab_mask.dtype == torch.bool:
            logits = torch.where(vocab_mask, logits, float("-inf"))
        else:
            logits = logits + vocab_mask.float()
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


def top_logprobs(logits: torch.Tensor, k: int):
    """The k largest next-token log-probs of each row and their ids:
    ([B, k] float32, [B, k] int32), largest first."""
    vals, idx = torch.topk(torch.log_softmax(logits.float(), dim=-1), k, dim=-1)
    return vals, idx.to(torch.int32)
