"""FP8 weight quantization and the blockwise matmul's plain version (port of
semi_pd_tpu/ops/quant/fp8.py:24-73).

The quantizers follow the JAX order of operations in float32 (absmax,
scale = max(absmax / FP8_MAX, 1e-12), w / scale cast to e4m3 with
round-to-nearest-even), so they give the JAX package's bits. XLA computes
a division by a constant as the product with the constant's float32
reciprocal (``INV_FP8_MAX``), and so do these.
``blockwise_fp8_matmul`` is the plain version of the blockwise linear:
the weight dequantized to float32 times the expanded 128 x 128 scale,
rounded to x's dtype, then the product in float32, cast to x's dtype. On
the card the blockwise linears run ``ops/quant/wo_gemm.py wo_gemm_block``,
which does the same on each weight tile without a dequantized copy.

Leading dimensions (stacked layers, experts) are allowed in front of
[din, dout] in the quantizers.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # e4m3 finite max
INV_FP8_MAX = 1.0 / FP8_MAX  # XLA's x / FP8_MAX: x * float32(1 / FP8_MAX)


def quantize_fp8_per_channel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[.., din, dout] -> (fp8 [.., din, dout], scale [.., dout] float32):
    w ~ w_q * scale."""
    w32 = w.float()
    scale = torch.clamp(w32.abs().amax(dim=-2) * INV_FP8_MAX, min=1e-12)
    return (w32 / scale[..., None, :]).to(torch.float8_e4m3fn), scale


def quantize_fp8_blockwise(w: torch.Tensor, block: int = 128
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[.., din, dout] -> (fp8, scales [.., ceil(din/b), ceil(dout/b)]
    float32) with per-128x128-block scales (DeepSeek-V3 format); the
    padded tail blocks take the absmax of their real rows and columns."""
    din, dout = w.shape[-2:]
    wp = F.pad(w.float(), (0, (-dout) % block, 0, (-din) % block))
    lead = wp.shape[:-2]
    nb_i, nb_o = wp.shape[-2] // block, wp.shape[-1] // block
    blocks = wp.reshape(*lead, nb_i, block, nb_o, block)
    scale = torch.clamp(blocks.abs().amax(dim=(-3, -1)) * INV_FP8_MAX, min=1e-12)
    wq = (blocks / scale[..., :, None, :, None]).reshape(wp.shape)[..., :din, :dout]
    return wq.to(torch.float8_e4m3fn).contiguous(), scale


def expand_block_scales(ws: torch.Tensor, din: int, dout: int,
                        block: int = 128) -> torch.Tensor:
    """Block scales [ceil(din/b), ceil(dout/b)] -> one per weight [din, dout]."""
    return ws.repeat_interleave(block, 0)[:din].repeat_interleave(block, 1)[:, :dout]


def blockwise_fp8_matmul(x: torch.Tensor, w: torch.Tensor, ws: torch.Tensor,
                         block: int = 128) -> torch.Tensor:
    """x [T, din] @ dequant(w fp8 [din, dout], ws [din/b, dout/b]): the
    plain version (writes the dequantized weight)."""
    din, dout = w.shape
    wd = (w.float() * expand_block_scales(ws.float(), din, dout, block)).to(x.dtype)
    return torch.matmul(x.float(), wd.float()).to(x.dtype)


def quantize_fp8_per_token(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Activation quant: [T, d] -> (fp8, scale [T] float32)."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax(dim=-1) * INV_FP8_MAX, min=1e-12)
    return (x32 / scale[:, None]).to(torch.float8_e4m3fn), scale
