"""Rotary position embeddings (port of semi_pd_tpu/ops/rope.py, default and
llama3 frequency families).

The float32 cos/sin table is computed once in float64 numpy, exactly as the
JAX package does, and gathered by absolute position per step. yarn, linear,
longrope and m-rope are ROADMAP A14.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _default_inv_freq(rot_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, rot_dim, 2, dtype=np.float64) / rot_dim))


def _llama3_scale_inv_freq(inv_freq: np.ndarray, scaling: Dict[str, Any]) -> np.ndarray:
    factor = scaling.get("factor", 8.0)
    low_factor = scaling.get("low_freq_factor", 1.0)
    high_factor = scaling.get("high_freq_factor", 4.0)
    old_ctx = scaling.get("original_max_position_embeddings", 8192)
    low_wavelen = old_ctx / low_factor
    high_wavelen = old_ctx / high_factor
    wavelen = 2 * math.pi / inv_freq
    out = np.where(wavelen > low_wavelen, inv_freq / factor, inv_freq)
    smooth = (old_ctx / wavelen - low_factor) / (high_factor - low_factor)
    smoothed = (1 - smooth) / factor * inv_freq + smooth * inv_freq
    mid = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
    return np.where(mid, smoothed, out)


class RotaryEmbedding(torch.nn.Module):
    """Holds a precomputed cos/sin table; applied positionally per token to
    the two halves of the rotary dims (GPT-NeoX style, as Llama uses)."""

    def __init__(
        self,
        head_dim: int,
        rotary_dim: Optional[int] = None,
        max_position: int = 8192,
        theta: float = 10000.0,
        rope_scaling: Optional[Dict[str, Any]] = None,
    ):
        super().__init__()
        self.head_dim = head_dim
        self.rotary_dim = rotary_dim or head_dim
        inv_freq = _default_inv_freq(self.rotary_dim, theta)
        if rope_scaling:
            rtype = rope_scaling.get("rope_type", rope_scaling.get("type", ""))
            if rtype == "llama3":
                inv_freq = _llama3_scale_inv_freq(inv_freq, rope_scaling)
            elif rtype not in ("default", "dynamic"):
                raise NotImplementedError(f"rope_scaling {rtype!r} is ROADMAP A14")
        t = np.arange(max_position, dtype=np.float64)
        freqs = np.outer(t, inv_freq)  # [max_pos, rot_dim/2]
        self.register_buffer("cos", torch.from_numpy(np.cos(freqs).astype(np.float32)),
                             persistent=False)
        self.register_buffer("sin", torch.from_numpy(np.sin(freqs).astype(np.float32)),
                             persistent=False)

    def forward(self, positions: torch.Tensor, q: torch.Tensor,
                k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """positions: [T]; q: [T, Hq, D]; k: [T, Hk, D]."""
        p = positions.long()
        cos = self.cos[p][:, None, :]
        sin = self.sin[p][:, None, :]
        return (_apply_rope(q, cos, sin, self.rotary_dim),
                _apply_rope(k, cos, sin, self.rotary_dim))


def _apply_rope(x, cos, sin, rotary_dim: int):
    dtype = x.dtype
    rot = x[..., :rotary_dim].float()
    rest = x[..., rotary_dim:]
    x1, x2 = rot.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(dtype)
    if rest.shape[-1]:
        out = torch.cat([out, rest.to(dtype)], dim=-1)
    return out
