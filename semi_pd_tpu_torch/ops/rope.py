"""Rotary position embeddings (port of semi_pd_tpu/ops/rope.py: the default,
llama3, linear, yarn / deepseek_yarn and longrope / su frequency families).

The float32 cos/sin table is computed once in float64 numpy, exactly as the
JAX package does, and gathered by absolute position per step. yarn scales
the table by its ``mscale`` (DeepSeek-yarn: mscale / mscale_all_dim) and
spans ``original_max_position_embeddings * factor`` positions. longrope
(Phi-3's, MiniCPM3's; "su" is Phi-3-small's spelling) divides the
frequencies by a per-channel short factor below
``original_max_position_embeddings`` and a long one from there on, and
scales the table by sqrt(1 + ln(s) / ln(orig)) when the table reaches past
orig (s = its length / orig), or by explicit ``short_mscale`` /
``long_mscale`` per position. linear divides the frequencies by
its factor. "dynamic" is served as the base table, as the JAX package
serves it. Rotation is GPT-NeoX style (two halves, Llama, MiniCPM3's pe
head) or GPT-J interleaved (``is_neox_style=False``, DeepSeek, the GLM
family over the first ``rotary_dim`` dims). ``MRotaryEmbedding`` is
Qwen2-VL's multimodal rope: (t, h, w) positions, each frequency section
reading its own row.
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


def _yarn_find_dim(num_rot: float, rot_dim: int, theta: float, max_pos: int) -> float:
    return (rot_dim * math.log(max_pos / (num_rot * 2 * math.pi))) / (2 * math.log(theta))


def yarn_mscale(scale: float, m: float = 1.0) -> float:
    """YaRN's attention scale 0.1 * m * ln(scale) + 1 (1 when scale <= 1)."""
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def _yarn_inv_freq(rot_dim: int, theta: float,
                   scaling: Dict[str, Any]) -> Tuple[np.ndarray, float]:
    factor = scaling.get("factor", 1.0)
    orig_max = scaling.get("original_max_position_embeddings", 4096)
    beta_fast = scaling.get("beta_fast", 32)
    beta_slow = scaling.get("beta_slow", 1)
    extrapolation = _default_inv_freq(rot_dim, theta)
    interpolation = extrapolation / factor
    low = max(math.floor(_yarn_find_dim(beta_fast, rot_dim, theta, orig_max)), 0)
    high = min(math.ceil(_yarn_find_dim(beta_slow, rot_dim, theta, orig_max)), rot_dim - 1)
    ramp = np.clip((np.arange(rot_dim // 2, dtype=np.float64) - low)
                   / max(high - low, 0.001), 0, 1)
    mask = 1.0 - ramp
    inv_freq = interpolation * (1 - mask) + extrapolation * mask
    mscale_all_dim = scaling.get("mscale_all_dim", 0.0)
    if mscale_all_dim:  # DeepSeek-yarn attention scale adjustment
        mscale = (yarn_mscale(factor, scaling.get("mscale", 1.0))
                  / yarn_mscale(factor, mscale_all_dim))
    else:
        mscale = yarn_mscale(factor)
    return inv_freq, mscale


class RotaryEmbedding(torch.nn.Module):
    """Holds a precomputed cos/sin table; applied positionally per token to
    the rotary dims, as two halves (GPT-NeoX, Llama) or interleaved pairs
    (GPT-J, ``is_neox_style=False``)."""

    def __init__(
        self,
        head_dim: int,
        rotary_dim: Optional[int] = None,
        max_position: int = 8192,
        theta: float = 10000.0,
        rope_scaling: Optional[Dict[str, Any]] = None,
        is_neox_style: bool = True,
    ):
        super().__init__()
        self.head_dim = head_dim
        self.rotary_dim = rotary_dim or head_dim
        self.is_neox_style = is_neox_style
        self.mscale = 1.0
        inv_freq = _default_inv_freq(self.rotary_dim, theta)
        max_pos = max_position
        freqs = pos_mscale = None
        if rope_scaling:
            rtype = rope_scaling.get("rope_type", rope_scaling.get("type", ""))
            if rtype == "llama3":
                inv_freq = _llama3_scale_inv_freq(inv_freq, rope_scaling)
            elif rtype in ("yarn", "deepseek_yarn"):
                inv_freq, self.mscale = _yarn_inv_freq(self.rotary_dim, theta, rope_scaling)
                max_pos = int(rope_scaling.get("original_max_position_embeddings", max_pos)
                              * rope_scaling.get("factor", 1.0))
            elif rtype == "linear":  # positions interpolated by the factor
                inv_freq = inv_freq / rope_scaling.get("factor", 1.0)
            elif rtype in ("longrope", "su"):
                freqs, pos_mscale = self._longrope(inv_freq, max_pos, max_position,
                                                   rope_scaling)
            elif rtype not in ("default", "dynamic"):
                raise NotImplementedError(f"rope_scaling {rtype!r} is ROADMAP A14")
        if freqs is None:
            t = np.arange(max(max_pos, max_position), dtype=np.float64)
            freqs = np.outer(t, inv_freq)  # [max_pos, rot_dim/2]
        scale = self.mscale if pos_mscale is None else pos_mscale
        self.register_buffer(
            "cos", torch.from_numpy((np.cos(freqs) * scale).astype(np.float32)),
            persistent=False)
        self.register_buffer(
            "sin", torch.from_numpy((np.sin(freqs) * scale).astype(np.float32)),
            persistent=False)

    def _longrope(self, inv_freq, max_pos, max_position, scaling):
        """longrope's table (semi_pd_tpu/ops/rope.py:118-145): positions
        below orig take inv_freq / short_factor, the rest inv_freq /
        long_factor; returns (freqs, per-position scale or None). Sets
        ``mscale`` to sqrt(1 + ln(s) / ln(orig)) when the table reaches past
        orig; explicit short_mscale / long_mscale replace it."""
        orig = int(scaling.get("original_max_position_embeddings", max_pos))
        short = np.asarray(scaling["short_factor"], np.float64)
        longf = np.asarray(scaling["long_factor"], np.float64)
        scale = max(max_pos, max_position) / orig
        if scale > 1.0:
            self.mscale = math.sqrt(1 + math.log(scale) / math.log(orig))
        t = np.arange(max(max_pos, max_position), dtype=np.float64)
        freqs = np.where(t[:, None] < orig, np.outer(t, inv_freq / short),
                         np.outer(t, inv_freq / longf))
        if "short_mscale" in scaling or "long_mscale" in scaling:
            sm = float(scaling.get("short_mscale") or 1.0)
            lm = float(scaling.get("long_mscale") or sm)
            return freqs, np.where(t[:, None] < orig, sm, lm)
        return freqs, None

    def forward(self, positions: torch.Tensor, q: torch.Tensor,
                k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """positions: [T]; q: [T, Hq, D]; k: [T, Hk, D]."""
        p = positions.long()
        cos = self.cos[p][:, None, :]
        sin = self.sin[p][:, None, :]
        return (_apply_rope(q, cos, sin, self.rotary_dim, self.is_neox_style),
                _apply_rope(k, cos, sin, self.rotary_dim, self.is_neox_style))


def _apply_rope(x, cos, sin, rotary_dim: int, neox: bool = True):
    dtype = x.dtype
    rot = x[..., :rotary_dim].float()
    rest = x[..., rotary_dim:]
    if neox:
        x1, x2 = rot.chunk(2, dim=-1)
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    else:  # GPT-J interleaved pairs (2i, 2i + 1)
        x1, x2 = rot[..., 0::2], rot[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                          dim=-1).reshape(rot.shape)
    out = out.to(dtype)
    if rest.shape[-1]:
        out = torch.cat([out, rest.to(dtype)], dim=-1)
    return out


class MRotaryEmbedding(RotaryEmbedding):
    """Multimodal 3D rope (Qwen2-VL; port of semi_pd_tpu/ops/rope.py:186-212
    MRotaryEmbedding): the frequency channels are cut into ``mrope_section``
    [t, h, w] (summing to rotary_dim / 2), each section reading its cos/sin
    from its own component of a [T, 3] position; a [T] position is
    broadcast to all three, which gives the 1D rope. The table is the
    default one: a config's ``{"type": "mrope", "mrope_section": ...}``
    names this class and no other scaling (``rope_scaling`` of another type
    raises, as in RotaryEmbedding)."""

    def __init__(self, *args, mrope_section=None, rope_scaling=None, **kwargs):
        if rope_scaling and rope_scaling.get("rope_type", rope_scaling.get("type")) == "mrope":
            rope_scaling = None
        super().__init__(*args, rope_scaling=rope_scaling, **kwargs)
        if mrope_section is None or sum(mrope_section) != self.rotary_dim // 2:
            raise ValueError(f"mrope_section {mrope_section} must sum to rotary_dim / 2 = "
                             f"{self.rotary_dim // 2}")
        self.mrope_section = list(mrope_section)
        sel = np.repeat(np.arange(3), self.mrope_section)  # component per channel
        self.register_buffer("section", torch.from_numpy(sel), persistent=False)

    def forward(self, positions: torch.Tensor, q: torch.Tensor,
                k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """positions: [T, 3] (or [T], broadcast); q: [T, Hq, D]; k: [T, Hk, D]."""
        p = positions.long()
        if p.dim() == 1:
            p = p[:, None].expand(-1, 3)
        # each channel's row from its section's component: [T, rot/2]
        rows = torch.gather(p, 1, self.section[None, :].expand(p.shape[0], -1))
        chan = torch.arange(self.cos.shape[1], device=p.device)
        cos = self.cos[rows, chan][:, None, :]
        sin = self.sin[rows, chan][:, None, :]
        return (_apply_rope(q, cos, sin, self.rotary_dim, self.is_neox_style),
                _apply_rope(k, cos, sin, self.rotary_dim, self.is_neox_style))
