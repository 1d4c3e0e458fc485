"""Speculative decoding: NGRAM (prompt-lookup) drafting and the verify's
acceptance (port of semi_pd_tpu/runtime/speculative.py).

Drafts come from n-gram lookup over the request's own history; the verify
is ONE extend-shaped forward in which every draft row's logits are scored,
and acceptance and correction run on the device.

Chain drafts: gamma tokens per request per step. KV correctness: draft rows
write KV at their true positions during the verify; rejected rows leave
stale KV beyond kv_len, which is never read (attention stops at kv_lens)
and is overwritten when real tokens reach those positions.

The sampled draws take an explicit ``torch.Generator``; it cannot
reproduce ``jax.random``'s streams, so only greedy requests are comparable
token for token with the JAX package (ROADMAP C3).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from semi_pd_tpu_torch.ops.sampling import SamplingArrays
from semi_pd_tpu_torch.runtime.req import Req


def ngram_draft(req: Req, gamma: int, min_n: int = 1, max_n: int = 3) -> List[int]:
    """Prompt-lookup: find the most recent earlier occurrence of the current
    tail n-gram in the request's full history and copy the continuation."""
    hist = req.all_token_ids()
    L = len(hist)
    if L < 2 or gamma <= 0:
        return []
    for n in range(max_n, min_n - 1, -1):
        if L <= n:
            continue
        tail = hist[-n:]
        # scan backwards for the previous occurrence of `tail`
        for start in range(L - n - 1, -1, -1):
            if hist[start : start + n] == tail:
                cont = hist[start + n : start + n + gamma]
                if cont:
                    return cont
                break
    return []


def verify_and_accept(
    logits: torch.Tensor,  # [B*(g+1), V]: per draft row, request-major
    drafts: torch.Tensor,  # [B, g] int32 (padded with -1)
    draft_lens: torch.Tensor,  # [B] int32
    sampling: SamplingArrays,
    generator: torch.Generator,
    gamma: int,
    threshold_single: float = 1.0,
    threshold_acc: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (accept_len [B] int32, next_token [B] int32).

    Row j of request b holds the logits AFTER consuming token j of its
    verify window (row 0 = after the last accepted token), i.e. row j
    predicts draft j+1; the last row predicts the bonus token.

    Greedy requests accept while the argmax matches the draft. Sampling
    requests use exact rejection sampling against the deterministic draft
    (q = delta): accept draft t with probability p(t); on rejection draw from
    p with t removed, which is unbiased (Leviathan et al.).

    Relaxations (defaults exact): a draft is also accepted outright when
    p(t) > threshold_single, and the accept probability is raised from p to
    min(1, p / threshold_acc)."""
    B = drafts.shape[0]
    V = logits.shape[-1]
    dev = logits.device
    lg = logits.reshape(B, gamma + 1, V).float()

    temp = torch.clamp(sampling.temperature.float(), min=1e-6)[:, None, None]
    probs = torch.softmax(lg / temp, dim=-1)  # [B, g+1, V]

    draft_safe = torch.clamp(drafts.long(), min=0)
    # p_j = P(d_{j+1} | ...) from row j
    p_draft = torch.gather(probs[:, :gamma, :], 2, draft_safe[:, :, None])[..., 0]  # [B, g]

    greedy = sampling.temperature <= 0.0  # [B]
    argmaxes = torch.argmax(lg, dim=-1).to(torch.int32)  # [B, g+1]

    u = torch.rand((B, gamma), generator=generator, device=dev)
    ok_sample = u < p_draft / threshold_acc
    if threshold_single < 1.0:
        ok_sample |= p_draft > threshold_single
    ok_greedy = argmaxes[:, :gamma] == drafts.to(torch.int32)
    ok = torch.where(greedy[:, None], ok_greedy, ok_sample)
    valid = torch.arange(gamma, device=dev)[None, :] < draft_lens.long()[:, None]
    ok = ok & valid

    # accept_len = length of the all-true prefix
    accept_len = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1)

    # Correction/bonus token from row accept_len: the bonus row when all g
    # were accepted, else the first rejected row, drawn from p with the
    # rejected draft token removed
    acc = accept_len.long()
    row = probs[torch.arange(B, device=dev), acc]  # [B, V]
    rejected_tok = torch.nn.functional.pad(draft_safe, (0, 1)).gather(1, acc[:, None])[:, 0]
    fully_accepted = acc >= draft_lens.long()
    one_hot = torch.nn.functional.one_hot(rejected_tok, V).to(row.dtype)
    adj = torch.where(fully_accepted[:, None], row, row * (1 - one_hot))
    adj = adj / torch.clamp(adj.sum(-1, keepdim=True), min=1e-20)

    # categorical draw by Gumbel-argmax, as the sampler draws
    g = torch.rand((B, V), generator=generator, device=dev)
    gumbel = -torch.log(-torch.log(g.clamp_min(1e-20)))
    sampled = torch.argmax(torch.log(torch.clamp(adj, min=1e-30)) + gumbel, dim=-1)
    greedy_next = argmaxes.gather(1, acc[:, None])[:, 0]
    # greedy + rejection: the correction IS the argmax (!= draft by definition)
    next_token = torch.where(greedy, greedy_next, sampled.to(torch.int32))
    return accept_len.to(torch.int32), next_token.to(torch.int32)
