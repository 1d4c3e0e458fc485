"""Linear application with quantization dispatch (port of
semi_pd_tpu/layers/linear.py:30-63).

A linear is a weight ``w`` stored [din, dout] (already transposed for
``x @ w``, the JAX package's layout) plus an optional bias. Plain products
go to ``torch.matmul``, as the JAX package left them to XLA. A quantized
linear's weight is the JAX leaf dict (model_loader/quantize.py), here a
``QuantWeight`` (its layer given by indexing, as a stacked tensor's is) or
the dict itself:

- fp8 per-channel: ``w`` float8_e4m3fn, ``ws`` [dout] float32;
- fp8 blockwise:   ``w`` float8_e4m3fn, ``ws`` [din/128, dout/128] float32;
- int8 w8-only:    ``w`` int8, ``ws`` [dout] float32;
- AWQ int4:        ``w`` int8 (unpacked 4-bit), ``ws`` [din/g, dout] float32,
                   ``wz`` int8 [din/g, dout].

``apply_linear`` dispatches on the leaf as JAX does
(ops/quant/wo_gemm.py ``quant_matmul``: on the card the weight-only
dequant kernels, on the CPU their plain versions) and adds the bias last.
The embeddings and ``lm_head_logits`` stay unquantized, as in JAX.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from semi_pd_tpu_torch.model_loader.quantize import _quant_one
from semi_pd_tpu_torch.ops.quant.wo_gemm import quant_matmul


class QuantWeight(torch.nn.Module):
    """A quantized linear weight or expert stack: the JAX leaves ``w``,
    ``ws`` and (AWQ) ``wz`` as parameters, stacked on the leading axes the
    weight it replaces had. Indexing gives the leaves of one layer (or
    expert) as a dict, so ``self.qkv_proj[layer]`` is what ``apply_linear``
    and ``moe_ffn`` take whether the model is quantized or not."""

    def __init__(self, leaves: Dict[str, torch.Tensor], method: str,
                 src_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.method = method  # model_loader/quantize.py's, which fill() applies
        self.src_dtype = src_dtype  # the model dtype a weight is cast to before quantizing
        for name in ("w", "ws", "wz"):
            t = leaves.get(name)
            self.register_parameter(name, None if t is None else torch.nn.Parameter(
                t, requires_grad=False))

    def leaves(self) -> Dict[str, torch.Tensor]:
        return {n: t for n, t in (("w", self.w), ("ws", self.ws), ("wz", self.wz))
                if t is not None}

    def __getitem__(self, i) -> Dict[str, torch.Tensor]:
        return {n: t[i] for n, t in self.leaves().items()}

    @property
    def device(self) -> torch.device:
        return self.w.device

    @torch.no_grad()
    def fill(self, i, w: torch.Tensor) -> None:
        """Quantize ``w`` (one layer of the stack, ``i`` its index; None: the
        whole weight) into the leaves."""
        res = _quant_one(w, self.method)
        for name, t in zip(("w", "ws", "wz"), res):
            dst = getattr(self, name)
            (dst if i is None else dst[i]).copy_(t)


Weight = Union[torch.Tensor, QuantWeight, Dict[str, torch.Tensor]]


def apply_linear(x: torch.Tensor, w: Weight, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    if isinstance(w, QuantWeight):
        w = w.leaves()
    out = quant_matmul(x, w) if isinstance(w, dict) else torch.matmul(x, w)
    if b is not None:
        out = out + b.to(out.dtype)
    return out


def lm_head_logits(h: torch.Tensor, w: torch.Tensor, softcap: Optional[float] = None,
                   b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h [B, d] @ lm_head [d, V] (+ its bias b, Phi's) -> [B, V] float32."""
    logits = apply_linear(h, w, b).float()
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    return logits
