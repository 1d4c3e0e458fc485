"""Elementwise ops (port of semi_pd_tpu/ops/elementwise.py). Plain torch:
the JAX package leaves these to XLA fusion and has no kernel for them."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with float32 accumulation."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * weight.float()).to(x.dtype)


def fused_add_rms_norm(x, residual, weight, eps: float = 1e-6):
    """Returns (normed(x + residual), x + residual)."""
    resid = (x.float() + residual.float()).to(x.dtype)
    return rms_norm(resid, weight, eps), resid


def silu_and_mul(x: torch.Tensor) -> torch.Tensor:
    """SiLU(gate) * up over the concatenated last dim."""
    gate, up = x.chunk(2, dim=-1)
    return F.silu(gate) * up


def gelu_and_mul(x: torch.Tensor) -> torch.Tensor:
    """GELU(gate) * up with GELU's tanh approximation (JAX ``jax.nn.gelu(...,
    approximate=True)``, HF's ``gelu_pytorch_tanh``): Gemma's GeGLU."""
    gate, up = x.chunk(2, dim=-1)
    return F.gelu(gate, approximate="tanh") * up


ACT2FN = {"silu": silu_and_mul, "gelu": gelu_and_mul, "gelu_pytorch_tanh": gelu_and_mul}
