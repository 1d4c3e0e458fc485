"""Static speculation-tree template for EAGLE top-k tree drafting (copy of
semi_pd_tpu/speculative/tree.py in numpy, with its tables' device copies).

The tree SHAPE is a constant (node -> parent edges, per-node top-k rank),
as in the JAX package, where it keeps the round one statically shaped
program; here it keeps every launch of a round at a shape known before the
round. Only the node TOKENS are data.

Node 0 is the root (the last committed token). Nodes are numbered in BFS
order, so ``index >= depth`` always holds and ancestor indices are strictly
decreasing — which makes slot-order causal masking a superset of the tree
mask (the per-node ancestor bitmask then prunes non-ancestor edges).

The ancestor bitmask per node (including itself and the root) is the static
attention mask: node i may attend window slot j iff bit j of anc_bits[i] is
set. Capped at 31 nodes so a mask is one positive int32 (the CUDA extend
kernels take the table by value, ops/attention/ragged_paged_attention.py
``spec_anc``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

MAX_TREE_NODES = 31  # masks stay positive int32


@dataclasses.dataclass(frozen=True)
class TreeTemplate:
    branching: Tuple[int, ...]  # children per node at each level
    parents: np.ndarray  # [N] i32, parent node index (root: -1)
    depths: np.ndarray  # [N] i32, root = 0
    ranks: np.ndarray  # [N] i32, which top-k rank of the parent this node takes
    anc_bits: Tuple[int, ...]  # [N] ancestor bitmask incl. self + root
    anc_at_depth: np.ndarray  # [N, max_depth+1] ancestor node at depth d
    level_nodes: Tuple[Tuple[int, ...], ...]  # node ids per level (level 0 = (0,))
    # device copies of depths and anc_at_depth, by device (device_tables)
    _tables: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = dataclasses.field(
        default_factory=dict, repr=False)

    def device_tables(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """``depths`` [N] and ``anc_at_depth`` [N, depth + 1] as int64 on
        ``device``, copied there once: a tree round reads them without a
        host->device copy, which a CUDA graph cannot capture and which
        waits for the card."""
        key = str(torch.device(device))
        if key not in self._tables:
            self._tables[key] = tuple(torch.as_tensor(a, dtype=torch.int64, device=device)
                                      for a in (self.depths, self.anc_at_depth))
        return self._tables[key]

    @property
    def num_nodes(self) -> int:
        return len(self.parents)

    @property
    def depth(self) -> int:
        return len(self.branching)

    def __hash__(self):  # equal templates hash alike (a cache key)
        return hash(self.branching)

    def __eq__(self, other):
        return isinstance(other, TreeTemplate) and self.branching == other.branching


def build_tree_template(branching: Tuple[int, ...]) -> TreeTemplate:
    """``branching[d]`` = number of children every level-d node spawns.
    E.g. (4, 2, 1): root forks 4 ways, each forks 2, each of those extends
    by 1 -> 1 + 4 + 8 + 8 = 21 nodes, depth 3."""
    parents: List[int] = [-1]
    depths: List[int] = [0]
    ranks: List[int] = [0]
    level_nodes: List[Tuple[int, ...]] = [(0,)]
    for d, k in enumerate(branching):
        assert k >= 1
        lvl = []
        for p in level_nodes[d]:
            for r in range(k):
                lvl.append(len(parents))
                parents.append(p)
                depths.append(d + 1)
                ranks.append(r)
        level_nodes.append(tuple(lvl))
    N = len(parents)
    assert N <= MAX_TREE_NODES, (
        f"tree of {N} nodes exceeds the {MAX_TREE_NODES}-node int32-mask cap"
    )
    anc_bits = []
    max_depth = len(branching)
    anc_at_depth = np.zeros((N, max_depth + 1), np.int32)
    for i in range(N):
        bits = 0
        j = i
        while j >= 0:
            bits |= 1 << j
            anc_at_depth[i, depths[j]] = j
            j = parents[j]
        anc_bits.append(bits)
    return TreeTemplate(
        branching=tuple(branching),
        parents=np.asarray(parents, np.int32),
        depths=np.asarray(depths, np.int32),
        ranks=np.asarray(ranks, np.int32),
        anc_bits=tuple(anc_bits),
        anc_at_depth=anc_at_depth,
        level_nodes=tuple(level_nodes),
    )


def default_tree_template(topk: int, gamma: int) -> TreeTemplate:
    """Wide-then-narrow tree under the node cap: level 1 forks ``topk`` ways,
    later levels halve the branching (min 1) until depth ``gamma``."""
    branching: List[int] = []
    k = max(1, topk)
    n_nodes = 1
    for _ in range(max(1, gamma)):
        # shrink k if the next level would blow the cap
        while k > 1 and n_nodes + _level_size(branching, k) > MAX_TREE_NODES:
            k -= 1
        if n_nodes + _level_size(branching, k) > MAX_TREE_NODES:
            break
        branching.append(k)
        n_nodes += _level_size(branching[:-1], k)
        k = max(1, k // 2)
    return build_tree_template(tuple(branching))


def _level_size(branching: List[int], k: int) -> int:
    n = 1
    for b in branching:
        n *= b
    return n * k
