"""Continuous-batching scheduler with phase-wise disaggregated computation
(trimmed copy of semi_pd_tpu/runtime/scheduler.py).

The three semi-PD mechanisms, as the JAX package derives them:

1. **Compute isolation as a cadence guarantee.** Every semi-PD tick
   dispatches the decode step first, then at most one prefill chunk whose
   size is bounded by an allowance banked from elapsed decode time
   (``_prefill_chunk_budget``); a measured per-token prefill cost model
   (EWMA) converts the time allowance into tokens.
2. **Unified storage.** Prefill and decode are two shapes of one step over
   the same KV pool and weights (runtime/model_runner.py).
3. **Decode-owned admission.** PrefillAdder runs against the allocator
   decode uses; slots and pages are allocated before the prefill step is
   dispatched; retracted decodes re-queue at the head; finished prefills
   join the running batch in FIFO order.

Colocated mode (enable_semi_pd=False) is the inherited SGLang loop: a
prefill batch runs whenever one can form and may stall decode.

Kept from the JAX scheduler: both ticks, the in-flight ring with its
split flush, chained decode, cost accounting, adaptive ring depth,
``_prefill_chunk_budget``, radix prefix reuse, retraction,
``check_memory`` and speculative decoding (``speculative_algorithm``):
NGRAM and EAGLE chain and tree rounds (NEXTN taken as EAGLE, with the
runner's NextN draft on a DeepSeek target), each decode tick flushing the
ring and then speculating for the whole running batch (each round's
results read back in one device->host copy), EAGLE's extends returning
the hidden state that seeds the draft. Constrained and penalized
sampling: a batch holding a grammar request carries the [B, V] vocab mask
(``_vocab_mask``; a float32 bias instead when a custom logit processor is
active, the grammar's bans folded in as -inf), a penalized one the [B,
PENALTY_HIST] token histogram (``_penalty_arrays``); such steps and top-k
log-prob steps run synchronously (``runner.step_host`` /
``step_topk_host``), their decode batches never chained; a speculating
batch holding such a request falls back to a plain decode step; a grammar
whose next tokens are forced emits them without forwards (jump-forward,
``_maybe_jump_forward``) and the request re-queues as a partial prefill
owing their KV (``_fold_refill_parked``). Not in this slice: HiCache and
DP-attention partitions (ROADMAP A15).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections import Counter, deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from semi_pd_tpu_torch.config.server_args import ServerArgs
from semi_pd_tpu_torch.mem.chunk_cache import ChunkCache
from semi_pd_tpu_torch.mem.radix_cache import RadixCache
from semi_pd_tpu_torch.ops.sampling import PENALTY_HIST, PenaltyArrays
from semi_pd_tpu_torch.runtime.batch import (
    HostBatch,
    build_decode_batch,
    build_extend_batch,
    build_spec_verify_batch,
    build_tree_verify_batch,
)
from semi_pd_tpu_torch.runtime.forward_batch import ForwardMode
from semi_pd_tpu_torch.runtime.req import FinishReason, Req
from semi_pd_tpu_torch.runtime.schedule_policy import PrefillAdder, sort_waiting_queue
from semi_pd_tpu_torch.runtime.speculative import ngram_draft
from semi_pd_tpu_torch.sampling.logit_processor import resolve_processor

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class _RingEntry:
    """One dispatched step awaiting readback (see Scheduler._ring)."""

    kind: str  # "decode" | "extend"
    hb: HostBatch
    tokens: object  # device [B] i32
    logprobs: object  # device [B] f32
    epochs: List[int]
    admitted: Optional[List[Tuple[Req, int]]] = None  # extend only
    done_flags: Optional[List[bool]] = None  # extend only: prompt completed
    t_dispatch: float = 0.0
    hidden: Optional[np.ndarray] = None  # EAGLE extend: [B, H] hidden states
    tk_vals: Optional[np.ndarray] = None  # [B, k] top-k logprobs (sync only)
    tk_ids: Optional[np.ndarray] = None  # [B, k] top-k token ids


def _host_step(req: Req) -> bool:
    """A request whose next step needs host state the device does not have
    (its grammar's mask, its penalty histogram, a processor's bias): its
    decode steps are never chained and never speculated."""
    return req.grammar is not None or req.sampling_params.needs_per_step_host


class Scheduler:
    def __init__(self, server_args: ServerArgs, runner):
        self.args = server_args
        self.runner = runner
        self.page_size = server_args.page_size

        self.waiting: deque[Req] = deque()
        self.running: List[Req] = []
        self.reqs_by_rid: Dict[str, Req] = {}

        alloc = runner.page_allocator
        if server_args.disable_radix_cache:
            self.tree_cache = ChunkCache(self.page_size, alloc.free)
        else:
            self.tree_cache = RadixCache(self.page_size, alloc.free)

        # Bucket tables
        self.t_buckets = server_args.prefill_token_buckets
        self.b_buckets = server_args.decode_bs_buckets
        maxp = runner.req_pool.max_pages_per_req
        self.p_buckets = []
        p = 8
        while p < maxp:
            self.p_buckets.append(p)
            p *= 4
        self.p_buckets.append(maxp)

        # Cost model for semi-PD chunk sizing (EWMA, seconds). Prefill cost
        # is affine: chunk_time = overhead + cost_per_token * n.
        self._prefill_cost_per_token = 50e-6
        self._prefill_overhead = 3e-3
        self._decode_cost = 5e-3
        self._readback_cost = 5e-3
        # Banked prefill interference allowance (seconds), seeded at one
        # chunk overhead
        self._prefill_deficit = self._prefill_overhead
        self._now = time.monotonic  # injectable clock
        self._last_budget_t = self._now()
        self._recent_prefill_time = 0.0
        # Full wall time of a decode-only flush cycle INCLUDING the readback
        # wait (with asynchronous dispatch the device executes during it)
        self._cycle_base = 30e-3
        # Slew-limited EWMA: one stalled cycle moves an estimate at most
        # 2x / 0.5x
        self._ewma = lambda old, new: 0.8 * old + 0.2 * min(
            max(new, 0.5 * old), 2.0 * old
        )

        # In-flight step ring: dispatched steps whose results have not been
        # read back. Decode step N+1 is dispatched chained to step N's
        # still-on-device tokens, and results are read in ONE device->host
        # copy every overlap_depth steps.
        self._ring: List[_RingEntry] = []
        # Extend entries held across one flush (split flush): their device
        # work runs under the next blocking readback instead of in it.
        self._held: List[_RingEntry] = []
        self._last_decode = None  # (hb, dev_tokens) of newest in-flight decode
        self._decode_lag = 0  # in-flight decode steps ahead of host kv state
        self._cycle_t0 = None  # dispatch time of the cycle's first entry
        self.overlap_depth = max(1, server_args.overlap_depth)
        self.enable_overlap = not server_args.disable_overlap_schedule
        if not self.enable_overlap:
            self.overlap_depth = 1
        self._depth_floor = self.overlap_depth
        self._adaptive_depth = (
            server_args.adaptive_overlap_depth and self.enable_overlap
        )
        self._max_stall_s = (
            server_args.max_stall_ms / 1e3 if server_args.max_stall_ms
            else 4.0 * server_args.decode_slo_ms / 1e3
        )

        # Speculative decoding (NGRAM: runtime/speculative.py; EAGLE:
        # speculative/eagle.py rounds)
        self.spec_algo = server_args.speculative_algorithm
        if self.spec_algo == "NEXTN":
            # NextN/MTP (DeepSeek) rides the EAGLE round machinery; the
            # runner picked the NextN draft module by target architecture
            self.spec_algo = "EAGLE"
        self.spec_gamma = (
            server_args.speculative_num_draft_tokens
            if self.spec_algo in ("NGRAM", "EAGLE") else 0
        )
        self.n_spec_steps = 0
        self.n_spec_accepted = 0

        # Stats
        self._last_stats_log = time.monotonic()
        self.n_finished = 0
        self.n_retracted = 0
        self.n_jump_tokens = 0
        # Reqs that emitted grammar-forced tokens without forwards; folded
        # into a KV back-fill extend at the top of the next tick
        self._refill_parked: List[Req] = []
        self._penalty_trunc_warned = False
        self.n_cached_prefix_tokens = 0
        self.n_prefill_tokens = 0
        self.n_decode_tokens = 0

    # ================================================================ API
    def add_request(self, req: Req) -> None:
        if len(req.input_ids) >= self.runner.max_context_len:
            if self.args.allow_auto_truncate:
                keep = self.runner.max_context_len - 1
                logger.warning(
                    "rid=%s prompt %d > context %d: truncated to last %d tokens",
                    req.rid, len(req.input_ids), self.runner.max_context_len, keep)
                req.input_ids = req.input_ids[-keep:]
                req.origin_prompt_len = len(req.input_ids)
            else:
                req.finish_reason = FinishReason.ABORT
                return
        self.reqs_by_rid[req.rid] = req
        self.waiting.append(req)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running or self._ring or self._held
                    or self._refill_parked)

    def drain(self) -> None:
        """Release the requests a jump-forward finished (the next tick would)
        and read back in-flight steps whose requests have all finished."""
        self._fold_refill_parked()
        if (self._ring or self._held) and not (
                self.running or self.waiting or self._refill_parked):
            self._flush_ring()

    # ================================================================ tick
    def tick(self) -> List[Tuple[Req, int]]:
        """One scheduler iteration. Returns (req, new_token) pairs produced
        this tick (token == -1 for non-final prefill chunks)."""
        now = time.monotonic()
        if (now - self._last_stats_log > self.args.decode_log_interval
                and self.running):
            alloc = self.runner.page_allocator
            total = alloc.usable_pages
            used = total - alloc.available_pages()
            logger.info(
                "decode stats: #running=%d #queue=%d kv=%.1f%% "
                "gen=%d prefill=%d cached=%d retracted=%d",
                len(self.running), len(self.waiting), 100 * used / max(total, 1),
                self.n_decode_tokens, self.n_prefill_tokens,
                self.n_cached_prefix_tokens, self.n_retracted,
            )
            self._last_stats_log = now
        self._fold_refill_parked()
        if self.args.enable_semi_pd:
            return self._tick_semi_pd()
        return self._tick_colocated()

    def _tick_colocated(self) -> List[Tuple[Req, int]]:
        """Run a prefill batch when one can form, else a decode batch — a
        long prefill stalls decode for its duration. With enable_mixed_chunk
        the tick also runs the decode step alongside the chunk."""
        extend = self._form_extend_batch(self.args.chunked_prefill_size)
        if extend is not None:
            out = []
            if self.args.enable_mixed_chunk and (self.running or self._ring):
                out += self._run_decode()
            return out + self._run_extend(extend)
        if self.running or self._ring:
            return self._run_decode()
        return self._flush_ring()

    def _tick_semi_pd(self) -> List[Tuple[Req, int]]:
        """Decode first (cadence guaranteed), then at most one bounded
        prefill chunk on the same unified storage."""
        out = []
        if self.running or self._ring:
            out += self._run_decode()

        budget = self._prefill_chunk_budget()
        extend = self._form_extend_batch(budget) if budget > 0 else None
        if extend is not None:
            self._note_prefill_dispatch(sum(n for _, n in extend))
            out += self._run_extend(extend)
        if not out and not extend and self._held and not (
                self.running or self._ring):
            out += self._flush_ring()  # held extends are the only work left
        return out

    def _prefill_chunk_budget(self) -> int:
        """Tokens of prefill allowed NOW (0 = skip prefill this tick and keep
        banking allowance). The allowance accrues as a fraction of elapsed
        pure-decode wall time, bounded by the cycle-stretch and SLO bounds,
        ramping toward the prefill share under queue pressure, and is spent
        only on chunks worth their fixed overhead (see the JAX scheduler's
        docstring of the same method for the derivation)."""
        if self.args.prefill_chunk_budget_tokens:
            return min(
                self.args.prefill_chunk_budget_tokens, self.args.chunked_prefill_size
            )
        if not self.running:
            self._last_budget_t = self._now()
            return self.args.chunked_prefill_size
        depth = max(self.overlap_depth, 1)
        per_tick_pure = max(self._cycle_base / depth, 1e-6)
        now = self._now()
        dt = min(max(now - self._last_budget_t, 0.0), 1.0)
        self._last_budget_t = now
        dt_pure = max(dt - self._recent_prefill_time, 0.0)
        self._recent_prefill_time = 0.0
        share = self.args.semi_pd_prefill_share
        base_frac = max(self.args.semi_pd_max_cycle_stretch - 1.0, 0.0)
        cap_frac = share / max(1.0 - share, 0.05)
        slo_cycle = self.args.decode_slo_ms / 1e3 * depth
        slo_slack = ((slo_cycle - self._cycle_base) / depth) * share
        slo_frac = slo_slack / per_tick_pure
        if slo_slack > 0:
            frac = min(base_frac, max(slo_frac, 0.25 * base_frac))
            relief_cap = min(cap_frac, max(slo_frac, base_frac))
        else:
            frac = base_frac
            relief_cap = cap_frac
        if self.waiting:
            head_age = now - min(
                r.queue_time for r in list(self.waiting)[:8])
            relief_s = self.args.semi_pd_queue_relief_ms / 1e3
            ramp = min(max((head_age - relief_s) / relief_s, 0.0), 1.0)
            frac = frac + (max(relief_cap, frac) - frac) * ramp
        hidden_frac = (
            self._readback_cost / max(self._cycle_base, 1e-6)
            if self.enable_overlap else 0.0
        )
        grace_frac = (
            self.args.semi_pd_stretch_grace_ms / 1e3
            / max(self._cycle_base, 1e-6)
        )
        allow = (frac + hidden_frac + grace_frac) * dt_pure
        cost = max(self._prefill_cost_per_token, 1e-9)
        bank_cap = (
            self._prefill_overhead
            + self.args.chunked_prefill_size * cost
        )
        self._prefill_deficit = min(self._prefill_deficit + allow, bank_cap)
        ovh = min(self._prefill_overhead, 0.5 * self._prefill_deficit)
        tokens = int((self._prefill_deficit - ovh) / cost)
        tokens = (tokens // self.page_size) * self.page_size
        min_tokens = max(
            self.page_size,
            min(
                int(self.args.semi_pd_min_chunk_duty * self._prefill_overhead
                    / cost) // self.page_size * self.page_size,
                self.args.chunked_prefill_size,
            ),
        )
        if self.waiting:
            # a chunk that FINISHES a waiting prompt is worth dispatching
            # below the duty floor
            head_need = min(
                max(r.prompt_len - r.prefilled_len, 1)
                for r in list(self.waiting)[:8]
            )
            head_need = -(-head_need // self.page_size) * self.page_size
            min_tokens = min(min_tokens, head_need)
        if tokens < min_tokens:
            return 0  # keep banking
        return min(tokens, self.args.chunked_prefill_size)

    def _note_prefill_dispatch(self, n_tokens: int) -> None:
        """Spend the banked allowance for a dispatched chunk."""
        if not self.running:
            return  # free chunk: no decode cadence was at stake
        spent = self._prefill_overhead + n_tokens * self._prefill_cost_per_token
        self._prefill_deficit = max(0.0, self._prefill_deficit - spent)
        self._recent_prefill_time += spent

    # ================================================================ prefill
    def _form_extend_batch(self, token_budget: int) -> Optional[List[Tuple[Req, int]]]:
        if not self.waiting or token_budget <= 0:
            return None
        ordered = sort_waiting_queue(
            self.args.schedule_policy, list(self.waiting), self.tree_cache
        )
        adder = PrefillAdder(
            self.runner.page_allocator,
            self.runner.req_pool,
            token_budget,
            self.page_size,
            self.running,
            retract_headroom_tokens=self.args.retract_decode_steps
            * max(len(self.running), 1),
            max_batch_rows=min(64, self.runner.max_running_requests),
        )
        admitted: List[Tuple[Req, int]] = []
        for req in ordered:
            if len(self.running) + len(admitted) >= self.runner.max_running_requests:
                break
            prefix_pages = self._attach_prefix(req)
            n = adder.try_add(req, prefix_pages)
            if n is None:
                continue
            admitted.append((req, n))
        if not admitted:
            # nothing runs and the radix cache holds the pages the head of the
            # queue needs (a pool nearly full of finished requests' prefixes;
            # the admission counts free pages only): evict for it, or it waits
            # for ever (ROADMAP C16)
            if not self.running and self._evict_for(ordered[0], token_budget):
                return self._form_extend_batch(token_budget)
            return None
        # Allocate slots + pages NOW (decode-owned pre-allocation)
        final: List[Tuple[Req, int]] = []
        for req, n in admitted:
            if self._allocate_for_extend(req, n):
                self.waiting.remove(req)
                final.append((req, n))
        return final or None

    def _evict_for(self, req: Req, token_budget: int) -> bool:
        """Evict unlocked radix-cache pages so that ``req``'s next chunk (up
        to ``token_budget`` tokens) and the admission's decode headroom fit;
        True if any page was freed."""
        n = min(req.prefill_remaining, token_budget)
        need = (-(-(req.prefilled_len + n) // self.page_size) - len(req.pages)
                + -(-self.args.retract_decode_steps // self.page_size) + 1)
        short = need - self.runner.page_allocator.available_pages()
        return short > 0 and self.tree_cache.evict(short) > 0

    def _attach_prefix(self, req: Req) -> int:
        """First-time admission: radix prefix reuse. A request whose prompt
        splices rows (images, input_embeds) bypasses the tree, which keys
        on token ids only: its placeholder ids are the same for every image
        (ROADMAP C19; the JAX scheduler bypasses input_embeds requests
        only)."""
        if req.req_slot is not None or req.prefilled_len > 0 or req.pages:
            return len(req.pages)
        if req.mm_embeds is not None:
            return 0
        pages, node = self.tree_cache.match_prefix(req.input_ids)
        # leave >= 1 uncached token to produce logits
        max_pages = (req.prompt_len - 1) // self.page_size
        n = min(len(pages), max_pages)
        if n > 0:
            req.pages = pages[:n].tolist()
            req.n_prefix_pages = n
            req.prefilled_len = n * self.page_size
            req.last_node = node
            req.cached_tokens = req.prefilled_len
            self.tree_cache.inc_lock_ref(node)
            self.n_cached_prefix_tokens += req.prefilled_len
        else:
            req.last_node = node
        return n

    def _allocate_for_extend(self, req: Req, n_tokens: int) -> bool:
        if req.req_slot is None:
            slot = self.runner.req_pool.alloc()
            if slot is None:
                return False
            req.req_slot = slot
            if req.pages:
                self.runner.req_pool.write(
                    slot, 0, np.asarray(req.pages, dtype=np.int32)
                )
        target_kv = req.prefilled_len + n_tokens
        need = (
            target_kv + self.page_size - 1
        ) // self.page_size - len(req.pages)
        if need > 0:
            pages = self._alloc_pages(need)
            if pages is None:
                return False
            self.runner.req_pool.write(req.req_slot, len(req.pages), pages)
            req.pages.extend(pages.tolist())
        return True

    PENALTY_HIST = PENALTY_HIST  # token-histogram width (ops/sampling.py)

    def _penalty_arrays(self, reqs: List[Req], B: int) -> Optional[PenaltyArrays]:
        """Compact per-request token histograms (numpy [B, H]) for a
        penalized batch, or None when no request uses penalties."""
        if not any(r.sampling_params.needs_penalties for r in reqs):
            return None
        H = self.PENALTY_HIST
        ids = np.full((B, H), -1, np.int32)
        counts = np.zeros((B, H), np.int32)
        in_prompt = np.zeros((B, H), bool)
        for i, r in enumerate(reqs):
            if not r.sampling_params.needs_penalties:
                continue
            out_c = Counter(r.full_output_ids())
            prompt_set = set(r.input_ids[: r.origin_prompt_len])
            # generated-token counts first: truncation drops prompt-set
            # entries, keeping frequency penalties exact for long outputs
            all_toks = list(dict.fromkeys(list(out_c.keys()) + list(prompt_set)))
            toks = all_toks[:H]
            if len(all_toks) > H and not self._penalty_trunc_warned:
                self._penalty_trunc_warned = True
                logger.warning("penalty histogram truncated to %d of %d distinct tokens "
                               "(prompt-set entries dropped first)", H, len(all_toks))
            for j, t in enumerate(toks):
                ids[i, j] = t
                counts[i, j] = out_c.get(t, 0)
                in_prompt[i, j] = t in prompt_set
        return PenaltyArrays(hist_ids=ids, hist_counts=counts, hist_prompt=in_prompt)

    def _vocab_mask(self, reqs: List[Req], B: int) -> Optional[np.ndarray]:
        """Dense [B, V] grammar mask (bool), or None when no request is
        constrained or processed. When a custom logit processor is active
        the return is a float32 additive bias instead, the grammar's bans
        folded in as -inf; the sampler picks where-vs-add by dtype."""
        has_grammar = any(r.grammar is not None for r in reqs)
        has_custom = any(r.sampling_params.custom_logit_processor is not None for r in reqs)
        if not has_grammar and not has_custom:
            return None
        V = self.runner.model_config.vocab_size
        if not has_custom:
            mask = np.ones((B, V), dtype=bool)
            for i, r in enumerate(reqs):
                if r.grammar is not None and not r.grammar.finished:
                    m = r.grammar.vocab_mask()
                    mask[i, : len(m)] = m
                    mask[i, len(m):] = False
            return mask
        bias = np.zeros((B, V), dtype=np.float32)
        for i, r in enumerate(reqs):
            if r.grammar is not None and not r.grammar.finished:
                m = r.grammar.vocab_mask()
                bias[i, : len(m)][~m] = -np.inf
                bias[i, len(m):] = -np.inf
            name = r.sampling_params.custom_logit_processor
            if name is not None:
                row = resolve_processor(name).bias(r.output_ids, r.sampling_params.custom_params, V)
                if row is not None:
                    merged = bias[i] + row
                    if np.isneginf(merged).all():
                        # grammar x processor bans everything (a thinking
                        # budget forcing a token the grammar forbids): the
                        # grammar wins, an all -inf row would NaN the softmax
                        logger.warning("custom logit processor %r bans every grammar-legal "
                                       "token for rid=%s; ignoring its bias this step",
                                       name, r.rid)
                    else:
                        bias[i] = merged
        return bias

    def _run_extend(self, admitted: List[Tuple[Req, int]]) -> List[Tuple[Req, int]]:
        """Dispatch a prefill/extend step. The common (unconstrained) path
        pushes the result onto the in-flight ring; the grammar, penalty,
        top-k and EAGLE paths stay synchronous (their host state depends on
        the tokens), EAGLE's returning the hidden states that seed the
        draft."""
        hb = build_extend_batch(
            admitted,
            self.runner.req_pool.page_table,
            self.page_size,
            self.t_buckets,
            self.b_buckets,
            self.p_buckets,
        )
        reqs = [r for r, _ in admitted]
        mask = self._vocab_mask(reqs, hb.B)
        pen = self._penalty_arrays(reqs, hb.B)
        topk = max((r.top_logprobs_num for r in reqs), default=0)
        out = []
        hidden = tkv = tki = None
        sync = True
        if self.spec_algo == "EAGLE" and pen is None and topk == 0:
            out += self._flush_ring()  # keep the token stream in order
            tokens, logprobs, hidden = self.runner.step_with_hidden_host(hb, mask)
        elif mask is None and pen is None and topk == 0:
            tokens, logprobs = self.runner.step_packed(hb)
            sync = False
        elif topk > 0:
            # top-k log-probs ride their own step variant, synchronously:
            # the [B, k] extras stay off the ring's readback
            out += self._flush_ring()
            tokens, logprobs, tkv, tki = self.runner.step_topk_host(hb, topk, mask, pen)
        else:
            out += self._flush_ring()
            tokens, logprobs = self.runner.step_host(hb, mask, pen)
        self._note_dispatch()
        self.n_prefill_tokens += sum(n for _, n in admitted)

        # Chunked requests go back to the queue head at dispatch time so the
        # next chunk can dispatch before this one's results are read.
        done_flags = []
        for req, n in admitted:
            req.prefilled_len += n
            done = req.prefilled_len >= req.prompt_len
            done_flags.append(done)
            if not done:
                self.waiting.appendleft(req)
        entry = _RingEntry(
            kind="extend", hb=hb, tokens=tokens, logprobs=logprobs,
            epochs=[r.epoch for r in reqs], admitted=list(admitted),
            done_flags=done_flags,
        )
        if sync:  # one device->host copy of the step's results
            toks, lps, entry.hidden, entry.tk_vals, entry.tk_ids = self.runner.read_round(
                tokens, logprobs, hidden, tkv, tki)
            return out + self._process_extend_entry(entry, toks, lps)
        return self._push_entry(entry)

    def _process_extend_entry(
        self, e: _RingEntry, tokens: np.ndarray, logprobs: Optional[np.ndarray]
    ) -> List[Tuple[Req, int]]:
        out = []
        for i, ((req, _n), done) in enumerate(zip(e.admitted, e.done_flags)):
            if req.epoch != e.epochs[i]:
                continue
            if not done:
                out.append((req, -1))
                continue
            tok = int(tokens[i])
            req.output_ids.append(tok)
            if e.hidden is not None:
                req.spec_hidden = e.hidden[i]
            if req.grammar is not None:
                req.grammar.accept_token(tok)
            self._record_logprobs(req, e, i, logprobs)
            if req.first_token_time is None:
                req.first_token_time = time.monotonic()
            req.check_finished()
            if req.finished:
                self._release_finished(req)
            else:
                self.running.append(req)
            out.append((req, tok))
            self._maybe_jump_forward(req, out)
        return out

    @staticmethod
    def _record_logprobs(req: Req, e: _RingEntry, i: int,
                         logprobs: Optional[np.ndarray]) -> None:
        """Row ``i``'s log-prob, and its top-k (values, ids) when the step
        extracted them, on a request that asked."""
        if req.return_logprob and logprobs is not None:
            req.output_logprobs.append(float(logprobs[i]))
            if req.top_logprobs_num and e.tk_vals is not None:
                n = req.top_logprobs_num
                req.output_top_logprobs.append(
                    (e.tk_vals[i][:n].tolist(), e.tk_ids[i][:n].tolist()))

    # ================================================================ ring
    def _note_dispatch(self) -> None:
        if self._cycle_t0 is None:
            self._cycle_t0 = time.monotonic()

    def _push_entry(self, e: _RingEntry) -> List[Tuple[Req, int]]:
        """Append to the in-flight ring, flushing first if the ring is at
        depth. Returns tokens produced by the flush (possibly none)."""
        out = []
        e.t_dispatch = time.monotonic()
        if len(self._ring) >= self._ring_target():
            out = self._flush_ring(hold_extends=True)
            self._note_dispatch()
            if e.kind == "decode":
                # e was chained before the flush and stays in flight
                self._last_decode = (e.hb, e.tokens)
                self._decode_lag = 1
        self._ring.append(e)
        return out

    def _flush_ring(self, hold_extends: bool = False) -> List[Tuple[Req, int]]:
        """Read back in-flight steps in ONE device->host copy and process the
        results in dispatch order. With hold_extends, this cycle's extend
        entries are held for the next flush (split flush)."""
        if not (self._ring or self._held):
            return []
        ring, self._ring = self._ring, []
        entries = self._held + ring
        self._held = []
        if hold_extends:
            tail = [e for e in ring if e.kind == "extend"]
            if tail and len(tail) < len(entries):
                self._held = tail
                held_ids = {id(e) for e in tail}
                entries = [e for e in entries if id(e) not in held_ids]
        self._last_decode = None
        self._decode_lag = 0
        t_read0 = time.monotonic()
        want_lps = any(r.return_logprob for e in entries for r in e.hb.reqs)
        toks_np, lps_np = self.runner.read_results(
            [e.tokens for e in entries], [e.logprobs for e in entries],
            want_logprobs=want_lps,
        )
        now = time.monotonic()
        self._readback_cost = self._ewma(self._readback_cost, now - t_read0)
        if self._cycle_t0 is not None:
            self._account_costs(entries, now - self._cycle_t0)
        self._cycle_t0 = None
        self._adapt_depth()
        out = []
        for e, t_np, l_np in zip(entries, toks_np, lps_np):
            if e.kind == "decode":
                out += self._process_decode_entry(e, t_np, l_np)
            else:
                out += self._process_extend_entry(e, t_np, l_np)
        return out

    def _account_costs(self, entries: List[_RingEntry], dt: float) -> None:
        """Attribute a flush cycle's full wall time to the cost EWMAs that
        drive the semi-PD chunk budget: decode-only cycles set the cycle
        base; mixed cycles' surplus over it is the (affine) prefill cost."""
        if dt <= 0:
            return
        n_dec = sum(1 for e in entries if e.kind == "decode")
        exts = [e for e in entries if e.kind == "extend"]
        pre_toks = sum(sum(n for _, n in e.admitted) for e in exts)
        if n_dec and not pre_toks:
            depth = max(self.overlap_depth, 1)
            scaled = dt * depth / max(n_dec, 1)
            self._cycle_base = self._ewma(self._cycle_base, scaled)
            self._decode_cost = self._ewma(
                self._decode_cost,
                max(dt - self._readback_cost, 1e-4) / max(n_dec, 1),
            )
            self._adapt_depth()
            return
        if not exts:
            return
        base = self._cycle_base * n_dec / max(self.overlap_depth, 1)
        est = dt - base
        if est <= 0:
            return
        if pre_toks / len(exts) >= 256:
            slope = (est - len(exts) * self._prefill_overhead) / pre_toks
            if slope > 0:
                self._prefill_cost_per_token = self._ewma(
                    self._prefill_cost_per_token, slope
                )
        elif not n_dec:
            # overhead only from pure-extend cycles
            ovh = (est - self._prefill_cost_per_token * pre_toks) / len(exts)
            self._prefill_overhead = self._ewma(
                self._prefill_overhead, max(ovh, 0.0)
            )

    def _adapt_depth(self) -> None:
        """Re-size the in-flight ring toward ceil(readback / step), capped by
        the stall bound and max_overlap_depth, slew-limited to 2x."""
        if not self._adaptive_depth:
            return
        step = max(self._decode_cost, 1e-5)
        want = -(-self._readback_cost // step)  # ceil
        stall_cap = (self._max_stall_s - self._readback_cost) / step
        want = min(want, stall_cap, float(self.args.max_overlap_depth),
                   2.0 * self.overlap_depth)
        floor = min(self._depth_floor, self.args.max_overlap_depth)
        self.overlap_depth = max(int(want), floor, 1)

    def _ring_target(self) -> int:
        """Flush threshold: the adaptive depth, capped by the most decode
        tokens any running request still needs."""
        d = max(self.overlap_depth, 1)
        if self.running:
            rem = max(
                (r.sampling_params.max_new_tokens or d) - len(r.output_ids)
                for r in self.running
            )
            d = max(1, min(d, rem))
        return d

    # ================================================================ decode
    def _run_decode(self) -> List[Tuple[Req, int]]:
        """When the running batch is unchanged since the newest in-flight
        decode, dispatch the NEXT step chained to its on-device tokens;
        otherwise flush, then dispatch fresh from host state. Speculating,
        flush, then run one speculative round for the running batch. A
        batch with a top-k log-prob request runs a synchronous top-k step
        instead, before speculation (no per-draft top-k is extracted)."""
        topk = max((r.top_logprobs_num for r in self.running), default=0)
        if topk > 0:
            out = self._flush_ring()
            if self.running:
                out += self._decode_topk(topk)
            return out
        if self.spec_gamma > 0:
            out = self._flush_ring()
            if self.running:
                if self.spec_algo == "EAGLE":
                    out += self._run_eagle_decode()
                else:
                    out += self._run_spec_decode()
            return out
        chained = self._try_dispatch_chained() if self.enable_overlap else None
        if chained is not None:
            return self._push_entry(chained)
        out = self._flush_ring()
        if self.running:
            e = self._dispatch_decode()
            if e is not None:
                self._note_dispatch()
                e.t_dispatch = time.monotonic()
                self._ring.append(e)
        return out

    def _run_eagle_decode(self) -> List[Tuple[Req, int]]:
        """EAGLE round (speculative/eagle.py). Same batch geometry as the
        NGRAM verify window; drafts are generated on the device. A tree
        round when the runner has a tree and every request is greedy. A
        batch holding a grammar, penalized or processed request, or one
        whose draft has no hidden state yet, takes a plain decode step."""
        g = self.spec_gamma
        if any(_host_step(r) or r.spec_hidden is None for r in self.running):
            return self._fallback_plain_decode()

        tree = self.runner.tree_template
        if tree is not None and all(
            r.sampling_params.temperature <= 0.0 for r in self.running
        ):
            return self._run_eagle_tree_decode(tree)

        if not self._alloc_spec_pages([r.kv_len + 1 + g for r in self.running]):
            return self._fallback_plain_decode()
        hb, _, _ = build_spec_verify_batch(
            self.running, [[0] * g for _ in self.running], g,
            self.runner.req_pool.page_table, self.page_size,
            self.b_buckets, self.p_buckets,
        )
        accept_len, next_tok, drafts, next_hidden = self.runner.eagle_step_host(
            hb, self._prev_hidden(hb), g)
        return self._commit_spec(hb.reqs, accept_len, next_tok, drafts, next_hidden)

    def _run_eagle_tree_decode(self, tree) -> List[Tuple[Req, int]]:
        """EAGLE top-k TREE round (speculative/eagle.py eagle_tree_round):
        drafts a static token tree, verifies every node with the target,
        accepts the deepest matching path and compacts its KV into slot
        order. Greedy only (the caller checked)."""
        if not self._alloc_spec_pages([r.kv_len + tree.num_nodes for r in self.running]):
            return self._fallback_plain_decode()
        hb = build_tree_verify_batch(
            self.running, tree,
            self.runner.req_pool.page_table, self.page_size,
            self.b_buckets, self.p_buckets,
        )
        accept_len, next_tok, path_tokens, next_hidden = (
            self.runner.eagle_tree_step_host(hb, self._prev_hidden(hb)))
        return self._commit_spec(hb.reqs, accept_len, next_tok, path_tokens, next_hidden)

    def _prev_hidden(self, hb: HostBatch) -> np.ndarray:
        prev = np.zeros((hb.B, self.runner.model_config.hidden_size), np.float32)
        for i, r in enumerate(hb.reqs):
            prev[i] = r.spec_hidden
        return prev

    def _alloc_spec_pages(self, targets: List[int]) -> bool:
        """Pages covering each running request's KV up to ``targets[i]``
        positions (its verify window); False when the pool runs out."""
        for r, target in zip(self.running, targets):
            need = (target + self.page_size - 1) // self.page_size - len(r.pages)
            if need > 0:
                pages = self._alloc_pages(need)
                if pages is None:
                    return False
                self.runner.req_pool.write(r.req_slot, len(r.pages), pages)
                r.pages.extend(pages.tolist())
        return True

    def _commit_spec(self, reqs: List[Req], accept_len, next_tok, drafts,
                     next_hidden=None) -> List[Tuple[Req, int]]:
        """Append each request's accepted drafts and its correction/bonus
        token (stopping at a finish), then release the finished. One
        device->host copy of the round's results (NGRAM's drafts are the
        host's already)."""
        accept_len, next_tok, drafts, next_hidden = self.runner.read_round(
            accept_len, next_tok, drafts, next_hidden)
        out = []
        still = []
        for i, req in enumerate(reqs):
            toks = list(drafts[i][: int(accept_len[i])]) + [int(next_tok[i])]
            self.n_spec_steps += 1
            self.n_spec_accepted += int(accept_len[i])
            if next_hidden is not None:
                req.spec_hidden = next_hidden[i]
            for tok in toks:
                req.output_ids.append(int(tok))
                self.n_decode_tokens += 1
                req.check_finished()
                out.append((req, int(tok)))
                if req.finished:
                    break
            if req.finished:
                self._release_finished(req)
            else:
                still.append(req)
        self.running = still
        return out

    def _fallback_plain_decode(self) -> List[Tuple[Req, int]]:
        """Synchronous plain decode step (the speculative paths' fallback):
        the ring is flushed when these run, so dispatch + flush reads just
        this one step."""
        e = self._dispatch_decode()
        if e is None:
            return []
        self._note_dispatch()
        e.t_dispatch = time.monotonic()
        self._ring.append(e)
        return self._flush_ring()

    def _run_spec_decode(self) -> List[Tuple[Req, int]]:
        """NGRAM speculative step: draft, verify in one forward, accept up to
        gamma+1 tokens per request (chain drafts, no tree, no draft
        model). A batch holding a grammar, penalized or processed request
        takes a plain decode step: its masks depend on each accepted
        token."""
        g = self.spec_gamma
        if any(_host_step(r) for r in self.running):
            return self._fallback_plain_decode()
        drafts = [ngram_draft(r, g) for r in self.running]
        # pages covering the last token + the drafts; even an empty draft
        # needs a page for the bonus token at a page boundary: plain decode
        # allocates it (and can retract)
        if not self._alloc_spec_pages([r.kv_len + 1 + len(d)
                                       for r, d in zip(self.running, drafts)]):
            return self._fallback_plain_decode()
        hb, drafts_np, draft_lens = build_spec_verify_batch(
            self.running, drafts, g,
            self.runner.req_pool.page_table, self.page_size,
            self.b_buckets, self.p_buckets,
        )
        accept_len, next_tok = self.runner.spec_step_host(hb, drafts_np, draft_lens, g)
        return self._commit_spec(hb.reqs, accept_len, next_tok, drafts_np)

    def _decode_topk(self, k: int) -> List[Tuple[Req, int]]:
        """Synchronous decode step with the top-k log-probs extracted on the
        device. Called with the ring flushed; its results are processed at
        once (the ring's readback carries tokens and log-probs only)."""
        if not self._prepare_decode_pages(lag=0):
            return []
        hb = build_decode_batch(
            self.running,
            self.runner.req_pool.page_table,
            self.page_size,
            self.b_buckets,
            self.p_buckets,
        )
        mask = self._vocab_mask(self.running, hb.B)
        pen = self._penalty_arrays(self.running, hb.B)
        out = self.runner.step_topk_host(hb, k, mask, pen)
        self._note_dispatch()
        toks, lps, tkv, tki = self.runner.read_round(*out)
        e = _RingEntry(kind="decode", hb=hb, tokens=out[0], logprobs=out[1],
                       epochs=[r.epoch for r in hb.reqs], tk_vals=tkv, tk_ids=tki)
        # a synchronous step's wall is no flush cycle: keep it out of the
        # cost EWMAs that drive the semi-PD chunk budget
        self._cycle_t0 = None
        return self._process_decode_entry(e, toks, lps)

    def _dispatch_decode(self) -> Optional[_RingEntry]:
        """Build + dispatch a decode step from host state: with a grammar
        mask, a logit bias or penalties through ``step_host``. Called with
        the ring flushed."""
        if not self._prepare_decode_pages(lag=0):
            return None
        hb = build_decode_batch(
            self.running,
            self.runner.req_pool.page_table,
            self.page_size,
            self.b_buckets,
            self.p_buckets,
        )
        mask = self._vocab_mask(self.running, hb.B)
        pen = self._penalty_arrays(self.running, hb.B)
        if mask is None and pen is None:
            tokens, logprobs = self.runner.step_packed(hb)
        else:
            tokens, logprobs = self.runner.step_host(hb, mask, pen)
        self._last_decode = (hb, tokens)
        self._decode_lag = 1
        return _RingEntry(
            kind="decode", hb=hb, tokens=tokens, logprobs=logprobs,
            epochs=[r.epoch for r in hb.reqs],
        )

    def _try_dispatch_chained(self) -> Optional[_RingEntry]:
        """Dispatch step N+1 with step N's device tokens as inputs, when the
        batch is provably identical and needs no host state (a grammar's
        or a penalty's inputs depend on step N's token, which the host has
        not read). ``lag`` is the number of in-flight decode steps this
        batch is ahead of host state."""
        if self._last_decode is None or not self.running:
            return None
        hb_prev, dev_tokens = self._last_decode
        if hb_prev.mode != ForwardMode.DECODE or hb_prev.reqs != self.running:
            return None
        if any(_host_step(r) for r in self.running):
            return None
        lag = self._decode_lag
        if not self._prepare_decode_pages(lag=lag, allow_retract=False):
            return None
        hb = build_decode_batch(
            self.running,
            self.runner.req_pool.page_table,
            self.page_size,
            self.b_buckets,
            self.p_buckets,
            lag=lag,
        )
        if hb.B != hb_prev.B:
            return None
        tokens, logprobs = self.runner.step_packed(hb, prev_tokens=dev_tokens)
        self._last_decode = (hb, tokens)
        self._decode_lag = lag + 1
        return _RingEntry(
            kind="decode", hb=hb, tokens=tokens, logprobs=logprobs,
            epochs=[r.epoch for r in hb.reqs],
        )

    def _process_decode_entry(
        self, e: _RingEntry, tokens: np.ndarray, logprobs: Optional[np.ndarray]
    ) -> List[Tuple[Req, int]]:
        out = []
        for i, req in enumerate(e.hb.reqs):
            if req.epoch != e.epochs[i] or req.finished:
                # finished/retracted/jumped at an earlier in-flight step:
                # this step's token for it is discarded
                continue
            tok = int(tokens[i])
            req.output_ids.append(tok)
            self.n_decode_tokens += 1
            if req.grammar is not None:
                req.grammar.accept_token(tok)
            self._record_logprobs(req, e, i, logprobs)
            req.check_finished()
            out.append((req, tok))
            if req.finished:
                if req in self.running:
                    self.running.remove(req)
                self._release_finished(req)
            else:
                self._maybe_jump_forward(req, out)
        return out

    def _prepare_decode_pages(self, lag: int = 0, allow_retract: bool = True) -> bool:
        """Allocate the page each request needs for its next token; on
        exhaustion retract newest requests back to waiting."""
        while self.running:
            need_idx = [
                i for i, r in enumerate(self.running)
                if (r.kv_len + lag) % self.page_size == 0
                and len(r.pages) * self.page_size <= r.kv_len + lag
            ]
            if not need_idx:
                return True
            pages = self._alloc_pages(len(need_idx))
            if pages is not None:
                for j, i in enumerate(need_idx):
                    r = self.running[i]
                    self.runner.req_pool.write(
                        r.req_slot, len(r.pages), pages[j : j + 1]
                    )
                    r.pages.append(int(pages[j]))
                return True
            if not allow_retract:
                return False
            # Retract the newest request (LIFO — oldest keep making progress).
            victim = self.running.pop()
            self._retract(victim)
            if not self.running:
                # the whole pool is held by the radix cache: drop it
                self.tree_cache.evict(10**9)
        return bool(self.running)

    def _retract(self, req: Req) -> None:
        self.n_retracted += 1
        self._free_req_memory(req)
        req.reset_for_retract()
        self.waiting.appendleft(req)

    # ================================================================ memory
    def _alloc_pages(self, n: int) -> Optional[np.ndarray]:
        alloc = self.runner.page_allocator
        pages = alloc.alloc(n)
        if pages is None:
            self.tree_cache.evict(n - alloc.available_pages())
            pages = alloc.alloc(n)
        return pages

    def _free_req_memory(self, req: Req) -> None:
        """Free owned pages; shared prefix pages return to the tree."""
        own = req.pages[req.n_prefix_pages :]
        if own:
            self.runner.page_allocator.free(np.asarray(own, dtype=np.int32))
        if req.last_node is not None and req.n_prefix_pages > 0:
            self.tree_cache.dec_lock_ref(req.last_node)
        if req.req_slot is not None:
            self.runner.req_pool.free(req.req_slot)
        req.pages = []
        req.n_prefix_pages = 0
        req.req_slot = None
        req.last_node = None

    # ================================================================ jump-forward
    def _maybe_jump_forward(self, req: Req, out: list) -> None:
        """After a sampled token advanced the grammar, emit its forced-token
        chain without model forwards. The request is parked; its KV debt is
        back-filled by an extend before it decodes again."""
        if (
            self.args.disable_jump_forward
            or req.grammar is None
            or req.grammar.finished
            or req.finished
            # a custom logit processor must see every emitted position; the
            # grammar's forced chain would bypass its bias
            or req.sampling_params.custom_logit_processor is not None
        ):
            return
        jf = req.grammar.jump_forward_tokens()
        if len(jf) < 2:
            return
        for tok in jf:
            req.output_ids.append(tok)
            req.kv_debt += 1
            req.grammar.accept_token(tok)
            self.n_jump_tokens += 1
            out.append((req, tok))
            req.check_finished()
            if req.finished:
                break
        if req in self.running:
            self.running.remove(req)
        # any in-flight step that sampled for this request is stale: the
        # jumped tokens supersede the chained continuation
        req.epoch += 1
        self._refill_parked.append(req)

    def _fold_refill_parked(self) -> None:
        """Move jump-forward requests to the waiting queue as partial
        prefills: generated tokens fold into the input (as in retraction)
        but memory and valid KV are kept; only the debt tokens get
        prefilled."""
        if not self._refill_parked:
            return
        for req in self._refill_parked:
            if req.finished:
                # finished during the jump: release with kv_len already
                # debt-adjusted for the radix insert
                self._release_finished(req)
                continue
            kv_valid = req.kv_len
            req.input_ids = req.all_token_ids()
            req.n_retracted_output += len(req.output_ids)
            req.output_ids = []
            req.prefilled_len = kv_valid
            req.kv_debt = 0
            req.spec_hidden = None
            self.waiting.appendleft(req)
        self._refill_parked = []

    def _release_finished(self, req: Req) -> None:
        """Finished: re-insert KV into the prefix cache, release the rest."""
        self.n_finished += 1
        req.finish_time = time.monotonic()
        if isinstance(self.tree_cache, ChunkCache) or req.mm_embeds is not None:
            # a spliced prompt's KV is not its ids' (C19): not inserted
            self._free_req_memory(req)
            return
        n_full = req.kv_len // self.page_size
        tokens = req.all_token_ids()[: n_full * self.page_size]
        pages = np.asarray(req.pages[:n_full], dtype=np.int32)
        dup, node = self.tree_cache.insert(tokens, pages)
        # pages[:n_prefix] were always the tree's; pages[n_prefix:dup] are
        # ours but identical content was inserted meanwhile — free ours
        if dup > req.n_prefix_pages:
            self.runner.page_allocator.free(
                np.asarray(req.pages[req.n_prefix_pages : dup], dtype=np.int32)
            )
        tail = req.pages[max(n_full, req.n_prefix_pages) :]
        if tail:
            self.runner.page_allocator.free(np.asarray(tail, dtype=np.int32))
        if req.last_node is not None and req.n_prefix_pages > 0:
            self.tree_cache.dec_lock_ref(req.last_node)
        if req.req_slot is not None:
            self.runner.req_pool.free(req.req_slot)
        req.pages = []
        req.n_prefix_pages = 0
        req.req_slot = None
        req.last_node = None

    def check_memory(self) -> None:
        """Idle-state leak check."""
        if self.running or self.waiting:
            raise AssertionError("check_memory called with requests in flight")
        cached = self.tree_cache.total_cached_pages()
        avail = self.runner.page_allocator.available_pages()
        total = self.runner.page_allocator.usable_pages
        if cached + avail != total:
            raise AssertionError(
                f"KV page leak: {avail} free + {cached} cached != {total}"
            )
        if self.runner.req_pool.available_slots() != self.runner.req_pool.max_reqs:
            raise AssertionError("req slot leak")
