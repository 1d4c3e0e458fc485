"""Page-granular radix prefix cache (copy of semi_pd_tpu/mem/radix_cache.py;
the port uses this pure-python tree, not the JAX package's native one).

Counterpart of the reference's RadixCache
(reference: python/sglang/srt/mem_cache/radix_cache.py:38-464 — prefix tree
over token ids with lock refcounts, LRU eviction, and re-insertion of
finished requests' KV at :168 cache_finished_req).

Two deliberate differences:

- **Page granularity.** The reference tree is token-granular (page_size=1
  default); ours shares KV only in whole pages (default 16 tokens), matching
  the paged TPU attention kernels. Node keys/splits land on page boundaries.
- **Semi-PD safe.** The reference *disables* radix cache in semi-PD mode
  because two OS processes would race on the tree (server_args.py:326-332).
  Here both phases live in one controller with a single-owner scheduler, so
  prefix caching works under phase disaggregation — a restriction lifted.
"""

from __future__ import annotations

import heapq
import itertools
from collections import defaultdict
from typing import Callable, List, Optional, Tuple

import numpy as np


# Logical LRU clock: deterministic tie-free ordering (and no syscall per
# touch); the native tree (csrc/radix_tree.cpp) uses the same scheme.
_CLOCK = itertools.count()


class TreeNode:
    __slots__ = ("children", "parent", "key", "pages", "lock_ref",
                 "last_access_time", "id", "detached")
    _id_counter = 0

    def __init__(self):
        self.children = {}  # first-page token tuple -> TreeNode
        self.parent: Optional["TreeNode"] = None
        self.key: Tuple[int, ...] = ()  # token ids, len % page_size == 0
        self.pages: np.ndarray = np.empty((0,), dtype=np.int32)
        self.lock_ref = 0
        self.detached = False  # set on eviction: stale handles must no-op
        self.last_access_time = next(_CLOCK)
        self.id = TreeNode._id_counter
        TreeNode._id_counter += 1

    def __lt__(self, other: "TreeNode"):
        return self.last_access_time < other.last_access_time


class RadixCache:
    def __init__(self, page_size: int, free_pages_fn: Callable[[np.ndarray], None]):
        self.page_size = page_size
        self.free_pages_fn = free_pages_fn
        self.reset()

    def reset(self):
        self.root = TreeNode()
        self.root.lock_ref = 1
        self.evictable_pages = 0
        self.protected_pages = 0
        # bumped on every content mutation; schedulers memoize lpm prefix
        # scores against it (schedule_policy.sort_waiting_queue)
        self.version = getattr(self, "version", 0) + 1

    # ------------------------------------------------------------- queries
    def match_prefix(self, token_ids: List[int]) -> Tuple[np.ndarray, TreeNode]:
        """Longest cached prefix of ``token_ids`` in whole pages.

        Returns (page_ids, last_node); page_ids covers ``len(page_ids) *
        page_size`` prefix tokens (reference radix_cache.py:92 match_prefix).
        """
        P = self.page_size
        n_pages = len(token_ids) // P
        key = tuple(token_ids[: n_pages * P])
        pages: List[np.ndarray] = []
        node = self.root
        while key:
            child = node.children.get(key[:P])
            if child is None:
                break
            child.last_access_time = next(_CLOCK)
            match = _shared_page_prefix_len(child.key, key, P)
            if match < len(child.key):
                if match == 0:
                    break
                child = self._split_node(child, match)
                pages.append(child.pages)
                node = child
                break
            pages.append(child.pages)
            node = child
            key = key[len(child.key):]
        out = (
            np.concatenate(pages).astype(np.int32)
            if pages else np.empty((0,), dtype=np.int32)
        )
        return out, node

    # ------------------------------------------------------------- updates
    def insert(self, token_ids: List[int], pages: np.ndarray) -> Tuple[int, TreeNode]:
        """Insert a (tokens → pages) mapping; returns (num_pages already
        present, last node). Caller frees the duplicate pages it handed in
        (reference radix_cache.py:128 insert → _insert_helper)."""
        self.version += 1
        P = self.page_size
        n_pages = len(token_ids) // P
        key = tuple(token_ids[: n_pages * P])
        pages = np.asarray(pages[:n_pages], dtype=np.int32)
        node = self.root
        matched_pages = 0
        while key:
            child = node.children.get(key[:P])
            if child is None:
                new = TreeNode()
                new.parent = node
                new.key = key
                new.pages = pages.copy()
                node.children[key[:P]] = new
                self.evictable_pages += len(new.pages)
                return matched_pages, new
            child.last_access_time = next(_CLOCK)
            match = _shared_page_prefix_len(child.key, key, P)
            if match < len(child.key):
                child = self._split_node(child, match)
            matched_pages += match // P
            node = child
            key = key[match:]
            pages = pages[match // P:]
        return matched_pages, node

    def _split_node(self, node: TreeNode, prefix_len: int) -> TreeNode:
        """Split ``node`` so its first ``prefix_len`` tokens become a new
        parent (reference radix_cache.py _split_node)."""
        P = self.page_size
        top = TreeNode()
        top.parent = node.parent
        top.key = node.key[:prefix_len]
        top.pages = node.pages[: prefix_len // P]
        top.lock_ref = node.lock_ref
        top.last_access_time = node.last_access_time
        top.parent.children[top.key[:P]] = top

        node.key = node.key[prefix_len:]
        node.pages = node.pages[prefix_len // P:]
        node.parent = top
        top.children[node.key[:P]] = node
        return top

    # ------------------------------------------------------------- locking
    def inc_lock_ref(self, node: TreeNode):
        if node is None or node.detached:
            return
        while node is not self.root and node is not None:
            if node.lock_ref == 0:
                self.evictable_pages -= len(node.pages)
                self.protected_pages += len(node.pages)
            node.lock_ref += 1
            node = node.parent

    def dec_lock_ref(self, node: TreeNode):
        if node is None or node.detached:
            return
        while node is not self.root and node is not None:
            node.lock_ref -= 1
            if node.lock_ref == 0:
                self.evictable_pages += len(node.pages)
                self.protected_pages -= len(node.pages)
            node = node.parent

    # ------------------------------------------------------------- evict
    def evict(self, num_pages: int) -> int:
        """LRU-evict unlocked leaves until ``num_pages`` freed (reference
        radix_cache.py:253 evict). Returns pages actually freed."""
        self.version += 1
        leaves = [n for n in self._collect_leaves() if n.lock_ref == 0]
        heapq.heapify(leaves)
        freed = 0
        while leaves and freed < num_pages:
            node = heapq.heappop(leaves)
            if node is self.root or node.children:
                continue
            self.free_pages_fn(node.pages)
            freed += len(node.pages)
            self.evictable_pages -= len(node.pages)
            node.detached = True
            parent = node.parent
            del parent.children[node.key[: self.page_size]]
            if (
                parent is not self.root
                and not parent.children
                and parent.lock_ref == 0
            ):
                heapq.heappush(leaves, parent)
        return freed

    def _collect_leaves(self) -> List[TreeNode]:
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            if not n.children:
                if n is not self.root:
                    out.append(n)
            else:
                stack.extend(n.children.values())
        return out

    # ------------------------------------------------------------- stats
    def total_cached_pages(self) -> int:
        return self.evictable_pages + self.protected_pages


def _shared_page_prefix_len(a: Tuple[int, ...], b: Tuple[int, ...], P: int) -> int:
    """Length (in tokens, multiple of P) of the shared whole-page prefix."""
    n = min(len(a), len(b)) // P
    match = 0
    for i in range(n):
        if a[i * P : (i + 1) * P] == b[i * P : (i + 1) * P]:
            match += P
        else:
            break
    return match
