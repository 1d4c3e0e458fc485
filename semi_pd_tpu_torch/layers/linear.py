"""Linear application (port of semi_pd_tpu/layers/linear.py, unquantized).

A linear is a weight ``w`` stored [din, dout] (already transposed for
``x @ w``, the JAX package's layout) plus an optional bias. Plain products
go to ``torch.matmul``, as the JAX package left them to XLA. Quantized
layouts (fp8, int8, AWQ int4) are ROADMAP A13.
"""

from __future__ import annotations

from typing import Optional

import torch


def apply_linear(x: torch.Tensor, w: torch.Tensor,
                 b: Optional[torch.Tensor] = None) -> torch.Tensor:
    out = torch.matmul(x, w)
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
