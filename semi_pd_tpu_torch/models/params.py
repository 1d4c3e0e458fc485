"""Parameters held as the JAX package's parameter tree, leaf for leaf.

A model module lists its leaves with ``param_specs()`` ((path, shape)
pairs in the order ``jax.tree`` visits the JAX tree: dict keys sorted,
list items in order; a path's parts are dict keys, or list indices written
as digits, e.g. ``"layers.3.kv_a.w"``) and returns each leaf's parameter
from ``leaf(path)``. This base gives it the JAX ``init_params(seed)``
numbers, ``load_jax_params`` and ``params_tree``. ``make_leaves`` gives a
module one parameter per leaf of its ``param_specs`` (named after the path,
"." as "__"), which the default ``leaf`` returns.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch


class TreeParams(torch.nn.Module):
    def param_specs(self) -> List[Tuple[str, Tuple[int, ...]]]:
        raise NotImplementedError

    def leaf(self, path: str) -> torch.nn.Parameter:
        return getattr(self, path.replace(".", "__"))

    def make_leaves(self, dtype: torch.dtype, device) -> None:
        """A zero parameter per leaf of ``param_specs`` that ``leaf`` reads
        by its own name."""
        for path, shape in self.param_specs():
            self.register_parameter(path.replace(".", "__"), torch.nn.Parameter(
                torch.zeros(shape, dtype=dtype, device=device), requires_grad=False))
    @torch.no_grad()
    def init_params(self, seed: int = 0) -> None:
        """Random init drawing the JAX ``init_params(seed)`` numbers: one
        numpy ``default_rng(seed)``, standard normals x0.02 per leaf in tree
        order, cast to the leaf's dtype (leaf by leaf, so the host holds one
        float32 leaf at a time)."""
        rng = np.random.default_rng(seed)
        for path, shape in self.param_specs():
            a = rng.standard_normal(shape, dtype=np.float32) * 0.02
            self.leaf(path).copy_(torch.from_numpy(a))

    @torch.no_grad()
    def load_jax_params(self, tree: Dict[str, Any]) -> None:
        """Copy a JAX-package parameter tree ({"embed": {"w": ...}, "layers":
        ..., ...}, numpy or array-like leaves) into the module."""
        for path, shape in self.param_specs():
            node = tree
            for key in path.split("."):
                node = node[int(key)] if isinstance(node, (list, tuple)) else node[key]
            a = np.asarray(node)
            if a.dtype != np.float32 or not a.flags.writeable:
                a = a.astype(np.float32)  # also copies read-only device views
            if a.shape != shape:
                raise ValueError(f"{path}: shape {a.shape} != {shape}")
            self.leaf(path).copy_(torch.from_numpy(a))

    def params_tree(self) -> Dict[str, Any]:
        """The parameters as a JAX-structured tree of float32 numpy arrays
        (lists where the JAX tree has lists)."""
        tree: Dict[str, Any] = {}
        for path, _ in self.param_specs():
            keys = path.split(".")
            node: Any = tree
            for key, nxt in zip(keys[:-1], keys[1:]):
                empty = [] if nxt.isdigit() else {}
                if isinstance(node, list):
                    if int(key) == len(node):
                        node.append(empty)
                    node = node[int(key)]
                else:
                    node = node.setdefault(key, empty)
            node[keys[-1]] = self.leaf(path).detach().float().cpu().numpy()
        return tree
