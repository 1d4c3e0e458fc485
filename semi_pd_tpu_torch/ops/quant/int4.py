"""INT4 (AWQ) weight-only checkpoints to linear leaves (copy of
semi_pd_tpu/ops/quant/int4.py:18-46, numpy).

AWQ checkpoints pack 8 4-bit values per int32 with the interleave order
[0, 2, 4, 6, 1, 3, 5, 7] applied to nibble positions; qzeros are packed
the same way; scales are [din/group, dout] fp16. The port holds the
unpacked values in int8, as the JAX package does: the leaves
``{"w": int8 [din, dout] in 0..15, "ws": float32 [din/g, dout], "wz":
int8 [din/g, dout]}`` that ``layers/linear.py apply_linear`` takes.
"""

from __future__ import annotations

import numpy as np

# AWQ nibble interleave: output column j of a packed int32 corresponds to
# nibble AWQ_ORDER[j].
AWQ_ORDER = [0, 4, 1, 5, 2, 6, 3, 7]


def unpack_awq_int32(packed: np.ndarray) -> np.ndarray:
    """[din, dout/8] int32 -> [din, dout] uint8 (values 0..15)."""
    din, dp = packed.shape
    out = np.empty((din, dp * 8), dtype=np.uint8)
    p = packed.view(np.uint32)
    for j, nib in enumerate(AWQ_ORDER):
        out[:, j::8] = ((p >> (4 * nib)) & 0xF).astype(np.uint8)
    return out


def awq_to_linear_params(
    qweight: np.ndarray,  # [din, dout/8] int32
    qzeros: np.ndarray,  # [din/g, dout/8] int32
    scales: np.ndarray,  # [din/g, dout] fp16
    group_size: int = 128,
) -> dict:
    """The quantized-linear leaf dict of an AWQ checkpoint's tensors: int8
    weights + group scales/zeros."""
    w = unpack_awq_int32(qweight).astype(np.int8)  # [din, dout]
    z = unpack_awq_int32(qzeros).astype(np.int8)  # [din/g, dout]
    return {
        "w": w,
        "ws": np.ascontiguousarray(scales.astype(np.float32)),
        "wz": z,
        "group_size": group_size,
    }
