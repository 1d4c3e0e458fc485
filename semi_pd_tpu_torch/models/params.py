"""Parameters held as the JAX package's parameter tree, leaf for leaf.

A model module lists its leaves with ``param_specs()`` ((path, shape)
pairs in the order ``jax.tree`` visits the JAX tree: dict keys sorted,
list items in order; a path's parts are dict keys, or list indices written
as digits, e.g. ``"layers.3.kv_a.w"``) and returns each leaf's parameter
from ``leaf(path)``. This base gives it the JAX ``init_params(seed)``
numbers, ``load_jax_params`` and ``params_tree``. ``make_leaves`` gives a
module one parameter per leaf of its ``param_specs`` (named after the path,
"." as "__"), which the default ``leaf`` returns.

Quantized weights: ``param_specs`` is the tree the JAX ``init_params``
draws. In a model whose ``config.quantization`` is set (fp8, int8,
blockwise_fp8, awq_int4), the leaves that the JAX ``quantize_params``
quantizes (model_loader/quantize.py ``quant_kind``: a linear's ``w`` under
QUANT_LEAF_NAMES, an expert stack) are made by ``new_leaf`` as a
``QuantWeight`` holding the quantized leaves, and ``leaf(path)`` returns
it. ``tree_specs()`` lists the served tree, the JAX quantized tree's
paths, shapes and dtypes (``X.w`` fp8 / int8, ``X.ws`` float32, ``X.wz``
int8; an expert stack ``X.w`` / ``X.ws``); ``params_tree`` returns it and
``load_jax_params`` takes it, or an unquantized tree, which it quantizes
leaf by leaf. Filling a leaf (``fill_leaf``) quantizes it right there, one
layer of a stacked leaf at a time, from the model dtype as JAX quantizes
its cast weights.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from semi_pd_tpu_torch.layers.linear import QuantWeight
from semi_pd_tpu_torch.model_loader.quantize import leaf_method, quant_kind, quant_shapes


@torch.no_grad()
def fill_leaf(leaf, value: torch.Tensor, index: Optional[int] = None) -> None:
    """Copy ``value`` into ``leaf`` (its layer ``index`` of a stacked leaf;
    None: all of it). A ``QuantWeight`` quantizes the value, cast to the
    model dtype first, a matrix at a time."""
    if not isinstance(leaf, QuantWeight):
        (leaf if index is None else leaf[index]).copy_(value)
        return
    value = value.to(device=leaf.w.device, dtype=leaf.src_dtype)
    if index is None and value.dim() > 2:
        for i in range(value.shape[0]):
            leaf.fill(i, value[i])
    else:
        leaf.fill(index, value)


def _numpy_to_torch(a: np.ndarray) -> torch.Tensor:
    """A numpy leaf as a tensor of its own dtype, bit for bit: ml_dtypes'
    float8_e4m3fn (the JAX quantized tree's) through its bytes."""
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(np.array(a).view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(np.array(a, copy=True))


def _torch_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A quantized leaf as numpy of its dtype (fp8 as ml_dtypes'
    float8_e4m3fn, imported here: the JAX side's type)."""
    t = t.detach().cpu()
    if t.dtype == torch.float8_e4m3fn:
        import ml_dtypes

        return t.view(torch.uint8).numpy().view(ml_dtypes.float8_e4m3fn)
    return t.numpy()


def _sub_path(path: str, name: str) -> str:
    """The served-tree path of quantized leaf ``name`` of the unquantized
    leaf ``path``: a linear's ``X.w`` -> ``X.<name>``, an expert stack
    ``X`` -> ``X.<name>``."""
    return path[:-1] + name if path.endswith(".w") else f"{path}.{name}"


def _node(tree, keys):
    for key in keys:
        tree = tree[int(key)] if isinstance(tree, (list, tuple)) else tree[key]
    return tree


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

    def new_leaf(self, path: str, shape: Tuple[int, ...], dtype: torch.dtype, device):
        """A zero leaf for ``path``: a parameter, or, where the model's
        ``config.quantization`` quantizes the leaf, a ``QuantWeight`` of
        the quantized leaves (``dtype`` the model dtype it is filled from)."""
        method = getattr(getattr(self, "config", None), "quantization", None)
        kind = quant_kind(path, len(shape)) if method else None
        if kind is None:
            return torch.nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                                      requires_grad=False)
        m = leaf_method(kind, method)
        leaves = {n: torch.zeros(s, dtype=dt, device=device)
                  for n, (s, dt) in quant_shapes(shape, m).items()}
        return QuantWeight(leaves, m, src_dtype=dtype)

    def tree_specs(self) -> List[Tuple[str, Tuple[int, ...], torch.dtype]]:
        """(path, shape, dtype) of every leaf of the served tree: the
        quantized leaves in place of the weights they replace."""
        out = []
        for path, shape in self.param_specs():
            leaf = self.leaf(path)
            if isinstance(leaf, QuantWeight):
                out += [(_sub_path(path, n), tuple(t.shape), t.dtype)
                        for n, t in leaf.leaves().items()]
            else:
                out.append((path, tuple(shape), leaf.dtype))
        return out

    @torch.no_grad()
    def init_params(self, seed: int = 0) -> None:
        """Random init drawing the JAX ``init_params(seed)`` numbers: one
        numpy ``default_rng(seed)``, standard normals x0.02 per leaf in tree
        order, cast to the leaf's dtype (leaf by leaf, so the host holds one
        float32 leaf at a time); a quantized leaf is quantized from them."""
        rng = np.random.default_rng(seed)
        for path, shape in self.param_specs():
            a = rng.standard_normal(shape, dtype=np.float32) * 0.02
            fill_leaf(self.leaf(path), torch.from_numpy(a))

    @torch.no_grad()
    def load_jax_params(self, tree: Dict[str, Any]) -> None:
        """Copy a JAX-package parameter tree ({"embed": {"w": ...}, "layers":
        ..., ...}, numpy or array-like leaves) into the module. A quantized
        tree (the JAX ``quantize_params``'s, ml_dtypes float8 leaves
        included) is copied bit for bit into a quantized model's leaves
        (fp8 and int8 values through their own dtypes, never through
        float32); an unquantized tree is quantized here."""
        for path, shape in self.param_specs():
            keys = path.split(".")
            leaf = self.leaf(path)
            node = _node(tree, keys)
            parent = _node(tree, keys[:-1])
            quantized = isinstance(node, dict) or (
                keys[-1] == "w" and isinstance(parent, dict) and "ws" in parent)
            if isinstance(leaf, QuantWeight) and quantized:
                src = node if isinstance(node, dict) else parent
                for name, dst in leaf.leaves().items():
                    a = _numpy_to_torch(np.asarray(src[name]))
                    if tuple(a.shape) != tuple(dst.shape) or a.dtype != dst.dtype:
                        raise ValueError(f"{_sub_path(path, name)}: {a.dtype} {tuple(a.shape)}"
                                         f" != {dst.dtype} {tuple(dst.shape)}")
                    dst.copy_(a)
                continue
            if quantized:
                raise ValueError(f"{path}: a quantized leaf for a model without "
                                 f"config.quantization")
            a = np.asarray(node)
            if a.dtype != np.float32 or not a.flags.writeable:
                a = a.astype(np.float32)  # also copies read-only device views
            if a.shape != shape:
                raise ValueError(f"{path}: shape {a.shape} != {shape}")
            fill_leaf(leaf, torch.from_numpy(a))

    def params_tree(self) -> Dict[str, Any]:
        """The parameters as a JAX-structured tree of numpy arrays (lists
        where the JAX tree has lists): float32, and the quantized leaves in
        their own dtypes (the JAX ``quantize_params`` tree's)."""
        tree: Dict[str, Any] = {}
        for path, shape in self.param_specs():
            leaf = self.leaf(path)
            if isinstance(leaf, QuantWeight):
                items = [(_sub_path(path, n), _torch_to_numpy(t))
                         for n, t in leaf.leaves().items()]
            else:
                items = [(path, leaf.detach().float().cpu().numpy())]
            for p, value in items:
                keys = p.split(".")
                node: Any = tree
                for key, nxt in zip(keys[:-1], keys[1:]):
                    empty = [] if nxt.isdigit() else {}
                    if isinstance(node, list):
                        if int(key) == len(node):
                            node.append(empty)
                        node = node[int(key)]
                    else:
                        node = node.setdefault(key, empty)
                node[keys[-1]] = value
        return tree
