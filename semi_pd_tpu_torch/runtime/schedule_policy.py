"""Admission policy for prefill batches (copy of
semi_pd_tpu/runtime/schedule_policy.py: ``sort_waiting_queue`` and
``PrefillAdder``).

The adder runs against the decode-owned memory accounting: prefill
admission is a plain function call into the same allocator decode uses.
"""

from __future__ import annotations

import random
from typing import List, Optional

from semi_pd_tpu_torch.mem.pool import PageAllocator, ReqToPagePool
from semi_pd_tpu_torch.runtime.req import Req


def sort_waiting_queue(policy: str, queue: List[Req], tree_cache) -> List[Req]:
    """Priority order of the waiting queue (lpm | fcfs | lof | random |
    dfs-weight)."""
    if policy == "fcfs":
        return list(queue)
    if policy == "lof":  # longest output first
        return sorted(queue, key=lambda r: -r.sampling_params.max_new_tokens)
    if policy == "random":
        q = list(queue)
        random.shuffle(q)
        return q
    if policy == "dfs-weight":
        # Heaviest-subtree-first DFS over the radix match nodes: deepest
        # shared prefixes schedule adjacently.
        root = getattr(tree_cache, "root", None)
        if root is not None and hasattr(root, "children"):
            node_reqs: dict = {}
            for r in queue:
                _, node = tree_cache.match_prefix(r.input_ids)
                node_reqs.setdefault(id(node), []).append(r)
            weight: dict = {}

            def calc(n):
                w = len(node_reqs.get(id(n), ()))
                for c in n.children.values():
                    w += calc(c)
                weight[id(n)] = w
                return w

            calc(root)
            out: List[Req] = []

            def dfs(n):
                kids = sorted(
                    n.children.values(), key=lambda x: -weight.get(id(x), 0)
                )
                for c in kids:
                    dfs(c)
                out.extend(node_reqs.get(id(n), ()))

            dfs(root)
            seen = {id(r) for r in out}
            out.extend(r for r in queue if id(r) not in seen)
            return out

    # lpm: longest cached prefix match first (default), memoized per request
    # against the tree's mutation counter
    if tree_cache is None:
        return list(queue)
    version = getattr(tree_cache, "version", None)
    scored = []
    for r in queue:
        memo = getattr(r, "_lpm_memo", None)
        if version is not None and memo is not None \
                and memo[0] == version and memo[1] == len(r.input_ids):
            score = memo[2]
        else:
            pages, _ = tree_cache.match_prefix(r.input_ids)
            score = len(pages)
            r._lpm_memo = (version, len(r.input_ids), score)
        scored.append((score, r))
    scored.sort(key=lambda x: -x[0])
    return [r for _, r in scored]


class PrefillAdder:
    """Selects which waiting requests join the next prefill batch, bounded by
    a token budget and page availability, with decode headroom reserved."""

    def __init__(
        self,
        page_allocator: PageAllocator,
        req_pool: ReqToPagePool,
        token_budget: int,
        page_size: int,
        running_reqs: List[Req],
        retract_headroom_tokens: int = 0,
        max_batch_rows: int = 64,
    ):
        self.page_allocator = page_allocator
        self.req_pool = req_pool
        self.rem_tokens = token_budget
        self.page_size = page_size
        self.max_batch_rows = max_batch_rows
        self.can_run: List[tuple] = []  # (req, n_extend_tokens)
        # Pages the running decode batch will need soon (headroom so admitting
        # prefill doesn't immediately force retraction).
        self._reserved_pages = (
            retract_headroom_tokens + self.page_size - 1
        ) // self.page_size + sum(
            1 for r in running_reqs if r.kv_len % page_size == 0
        )
        self._avail_pages = page_allocator.available_pages() - self._reserved_pages

    def try_add(self, req: Req, prefix_pages: int) -> Optional[int]:
        """Attempt to admit ``req``. Returns the number of tokens to extend
        this step (may be a chunk < remaining prompt), or None if it doesn't
        fit at all."""
        if len(self.can_run) >= self.max_batch_rows or self.rem_tokens <= 0:
            return None
        remaining = req.prefill_remaining
        extend = min(remaining, self.rem_tokens)
        if extend <= 0:
            return None
        target_kv = req.prefilled_len + extend
        have_pages = len(req.pages)
        need = (target_kv + self.page_size - 1) // self.page_size - have_pages
        if need > self._avail_pages:
            # Shrink to what fits (chunk by memory), page-aligned.
            fit_tokens = (have_pages + self._avail_pages) * self.page_size - req.prefilled_len
            extend = min(extend, fit_tokens)
            if extend <= 0:
                return None
            target_kv = req.prefilled_len + extend
            need = (target_kv + self.page_size - 1) // self.page_size - have_pages
        if req.req_slot is None and self.req_pool.available_slots() <= len(
            [r for r, _ in self.can_run if r.req_slot is None]
        ):
            return None
        self._avail_pages -= need
        self.rem_tokens -= extend
        self.can_run.append((req, extend))
        return extend
