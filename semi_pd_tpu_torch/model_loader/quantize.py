"""Post-load weight quantization (port of
semi_pd_tpu/model_loader/quantize.py:30-134).

Eligible leaves, as in JAX: the ``w`` of a linear under the projection
names ``QUANT_LEAF_NAMES`` (2D, or stacked [L, din, dout]), which becomes
``{"w", "ws"[, "wz"]}`` beside its bias; and the MoE expert stacks
``experts.gate_up`` / ``experts.down`` ([E, din, dout] or [L, E, din,
dout]), which become per-channel ``{"w", "ws"}`` (fp8 for ``fp8`` and
``blockwise_fp8``, int8 for ``int8`` and ``awq_int4``). Embeddings,
lm_head, norms, routers and every other leaf stay in the model dtype.

Memory: nothing here holds two whole trees. ``quantize_params`` replaces
each eligible leaf of the tree it is given right after quantizing it, and
a model's leaves are quantized as they are filled
(``models/params.py``: ``init_params``, ``load_jax_params`` and
``model_loader/loader.py device_init_params`` draw or read one layer of a
stacked leaf in the model dtype and quantize it into the model's
quantized leaves), so a model's peak is its quantized tree plus one layer
of one bf16 leaf and that layer's float32 copy.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Tuple

import torch

from semi_pd_tpu_torch.ops.quant.fp8 import quantize_fp8_blockwise, quantize_fp8_per_channel

logger = logging.getLogger(__name__)

QUANT_LEAF_NAMES = {
    "qkv_proj", "o_proj", "gate_up", "down", "q_proj", "q_a", "q_b", "kv_a",
}
# the method of a model's quantized expert stacks, by the model's method
EXPERT_METHOD = {"fp8": "fp8", "blockwise_fp8": "fp8", "int8": "int8", "awq_int4": "int8"}
METHODS = tuple(EXPERT_METHOD)
BLOCK = 128  # blockwise fp8's block, both axes


def awq_group(din: int, group_size: int = 0) -> int:
    """AWQ's group along din: ``group_size`` (default 128) halved until it
    divides din."""
    g = group_size or 128
    while din % g:
        g //= 2
    return g


def quant_kind(path: str, ndim: int) -> Optional[str]:
    """What ``quantize_params`` makes of the unquantized leaf at dotted tree
    path ``path`` (dict keys, list indices as digits) of ``ndim``
    dimensions: "linear" (the ``w`` of a node named in QUANT_LEAF_NAMES),
    "experts" (an expert stack), or None (kept)."""
    keys = path.split(".")
    if len(keys) < 2:
        return None
    if keys[-2] == "experts" and keys[-1] in ("gate_up", "down") and ndim >= 3:
        return "experts"
    if keys[-1] == "w" and keys[-2] in QUANT_LEAF_NAMES and ndim >= 2:
        return "linear"
    return None


def leaf_method(kind: str, method: str) -> str:
    """The method a leaf of ``kind`` is quantized with in a ``method`` model."""
    if method not in EXPERT_METHOD:
        raise ValueError(f"unknown quantization {method!r}: one of {METHODS}")
    return EXPERT_METHOD[method] if kind == "experts" else method


def quant_shapes(shape: Tuple[int, ...], method: str
                 ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """The quantized leaves ({"w", "ws"[, "wz"]}: (shape, dtype)) of a
    [.., din, dout] weight quantized with ``method``."""
    lead, (din, dout) = tuple(shape[:-2]), tuple(shape[-2:])
    if method == "fp8":
        return {"w": (tuple(shape), torch.float8_e4m3fn), "ws": (lead + (dout,), torch.float32)}
    if method == "int8":
        return {"w": (tuple(shape), torch.int8), "ws": (lead + (dout,), torch.float32)}
    if method == "blockwise_fp8":
        nb = (-(-din // BLOCK), -(-dout // BLOCK))
        return {"w": (tuple(shape), torch.float8_e4m3fn), "ws": (lead + nb, torch.float32)}
    if method == "awq_int4":
        grp = lead + (din // awq_group(din), dout)
        return {"w": (tuple(shape), torch.int8), "ws": (grp, torch.float32),
                "wz": (grp, torch.int8)}
    raise ValueError(f"unknown quantization {method!r}: one of {METHODS}")


def _quant_one(w: torch.Tensor, method: str, group_size: int = 0) -> Tuple[torch.Tensor, ...]:
    """Quantize a [.., din, dout] weight (leading dims: stacked layers or
    experts) in float32, the JAX order of operations: (wq, ws) or, for
    ``awq_int4``, (wq, ws, wz). A division by a constant is the product
    with its float32 reciprocal, as XLA computes it."""
    w32 = w.float()
    if method == "fp8":
        return quantize_fp8_per_channel(w32)
    if method == "blockwise_fp8":
        return quantize_fp8_blockwise(w32, BLOCK)
    if method == "int8":
        ws = torch.clamp(w32.abs().amax(dim=-2) * (1.0 / 127.0), min=1e-12)
        wq = torch.clamp(torch.round(w32 / ws[..., None, :]), -127, 127).to(torch.int8)
        return wq, ws
    if method == "awq_int4":
        # asymmetric group int4 (the serving format of AWQ / GPTQ
        # checkpoints): w int8 values 0..15, ws / wz [din/g, dout]
        *lead, din, dout = w32.shape
        g = awq_group(din, group_size)
        wg = w32.reshape(*lead, din // g, g, dout)
        wmin, wmax = wg.amin(dim=-2), wg.amax(dim=-2)
        ws = torch.clamp((wmax - wmin) * (1.0 / 15.0), min=1e-12)
        wz = torch.clamp(torch.round(-wmin / ws), 0, 15)
        wq = torch.clamp(torch.round(wg / ws[..., None, :]) + wz[..., None, :], 0, 15)
        return wq.to(torch.int8).reshape(w32.shape), ws, wz.to(torch.int8)
    raise ValueError(f"unknown quantization {method!r}: one of {METHODS}")


def quantize_params(params: Dict[str, Any], method: str, group_size: int = 0) -> Dict[str, Any]:
    """A parameter tree (dicts and lists of tensors, the JAX tree's
    structure) with its eligible leaves quantized, as the JAX
    ``quantize_params``: a linear's node keeps its other leaves (the bias)
    beside ``w`` / ``ws`` (/ ``wz``), an expert stack becomes ``{"w",
    "ws"}``. Each leaf is replaced as soon as it is quantized."""
    n_quant = [0]

    def quant(w, kind):
        n_quant[0] += 1
        return _quant_one(w, leaf_method(kind, method), group_size if kind == "linear" else 0)

    def rec(node, path):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                p = f"{path}.{k}" if path else k
                if isinstance(v, dict) and quant_kind(p + ".w", getattr(v.get("w"), "ndim", 0)):
                    res = quant(v["w"], "linear")
                    out[k] = {**v, **dict(zip(("w", "ws", "wz"), res))}
                elif torch.is_tensor(v) and quant_kind(p, v.ndim) == "experts":
                    out[k] = dict(zip(("w", "ws"), quant(v, "experts")))
                else:
                    out[k] = rec(v, p)
            return out
        if isinstance(node, list):
            return [rec(v, f"{path}.{i}") for i, v in enumerate(node)]
        return node

    out = rec(params, "")
    logger.info("quantized %d linear weights to %s", n_quant[0], method)
    return out
