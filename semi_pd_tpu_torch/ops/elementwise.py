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


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """GELU's tanh approximation (JAX ``jax.nn.gelu(x, approximate=True)``;
    HF's ``gelu_new`` and ``gelu_pytorch_tanh``)."""
    return F.gelu(x, approximate="tanh")


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """GELU through erf (JAX ``jax.nn.gelu(x, approximate=False)``, HF's
    ``gelu``)."""
    return F.gelu(x)


# the plain (non-gated) activations of the fc1 -> act -> fc2 MLPs
# (models/layernorm_families.py NonGatedMLPMixin), by HF name
PLAIN_ACT = {"gelu_new": gelu_tanh, "gelu_pytorch_tanh": gelu_tanh, "gelu": gelu_exact}


def layer_norm(x: torch.Tensor, p, eps: float) -> torch.Tensor:
    """LayerNorm in float32, cast back to x's dtype (port of the JAX
    package's ops/elementwise.py layer_norm): ``p`` is {"w", "b"} (GPT-2,
    StableLM, Phi, Falcon) or a bare weight (Cohere's and DBRX's bias-free
    LayerNorm), the call shape of ``rms_norm`` so that a model swaps it in
    through its ``norm_fn``."""
    w = p["w"] if isinstance(p, dict) else p
    b = p.get("b") if isinstance(p, dict) else None
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * w.float()
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def plain_layer_norm(x: torch.Tensor, p, eps: float) -> torch.Tensor:
    """LayerNorm without learnable parameters (OLMo-1's
    ``elementwise_affine=False``; the JAX package's olmo_falcon_dbrx.py
    ``_plain_ln``): ``p`` is the tree's placeholder leaf, unread."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)
