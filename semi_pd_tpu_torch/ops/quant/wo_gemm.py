"""Weight-only dequant GEMM: the quantized linears' and expert stacks'
kernels (csrc/wo_gemm.cu) and their plain versions.

They replace no Pallas kernel. The JAX package's quantized linears are XLA
ops (semi_pd_tpu/layers/linear.py:30-63 ``apply_linear`` /
``_awq_int4_matmul``, ops/quant/fp8.py:53-64 ``blockwise_fp8_matmul``,
ops/moe.py:75-88 ``expert_weights``), and XLA folds the weight's widening
and scale into the matmul's operand read: no dequantized copy of a weight
reaches device memory. The literal PyTorch translation (``x @
w.to(bf16) * ws``) writes one on every call, which costs more than the
bf16 weight it replaces, so on the card each quantized product is one
hand-written kernel that widens the weight tile in shared memory:

- ``wo_gemm``: fp8 e4m3 or int8 [K, N] with per-channel ``ws`` [N]; the
  product in float32, then x ws, then cast (the scale in the epilogue);
- ``wo_gemm_block``: fp8 e4m3 with 128 x 128 block scales ``ws``
  [ceil(K/128), ceil(N/128)]; each weight w * s in float32 rounded to
  bf16 on the tile, then the product;
- ``wo_gemm_awq``: int8 in 0..15 with group scales and zeros ``ws`` /
  ``wz`` [K/g, N]; (w - z) * s in float32 rounded to bf16 on the tile;
- ``wo_gemm_experts``: a quantized expert stack, fp8 or int8 [E, K, N]
  with ``ws`` [E, N], over rows sorted by expert whose group sizes stay on
  the device; w * s rounded to bf16 on the tile (``expert_weights``).

Each takes bf16 activations [T, K] and gives bf16 [T, N]; the bias is
added after, in the caller (``layers/linear.py``), as in JAX. One C entry
(``wo_gemm_launch``) serves the four, picking the kernel from its mode;
each is counted apart (``CudaKernel.instantiation``). A wrapper launches
its kernel for a CUDA tensor and takes the plain version only for a tensor
on the CPU; on the card a float32 activation or an e5m2 weight (which
nothing quantizes to) raises NotImplementedError naming ROADMAP B9.8, and
nothing falls back.

Decode-sized products (a few rows against a whole weight) are bound by the
weight's bytes; the dense kernels split K over blocks (``split_k``) when the
output tiles alone would not fill the card, leaving float32 partials that a
second pass behind the same entry sums in a fixed order and finishes
(scale, cast), so a result is the same from run to run.
"""

from __future__ import annotations

from typing import Optional

import torch

from semi_pd_tpu_torch.kernels import CudaKernel, cuda_stream_ptr, register
from semi_pd_tpu_torch.ops.attention.rpa_common import I, P
from semi_pd_tpu_torch.ops.attention.rpa_packed import sm_count
from semi_pd_tpu_torch.ops.quant.fp8 import blockwise_fp8_matmul

# the kernel tile (csrc/wo_gemm.cu's constexpr lines)
BM, BN, BK = 64, 64, 64
# the C entry's modes and weight types (csrc/wo_gemm.cu's enums)
MODE = {"wo_gemm": 0, "wo_gemm_block": 1, "wo_gemm_awq": 2, "wo_gemm_experts": 3}
WTYPE = {torch.float8_e4m3fn: 0, torch.int8: 1}
# split K only down to this many K tiles a split
MIN_SPLIT_TILES = 8

# mode, wtype, x, w, ws, wz, ends, y, partial, M, N, K, E, group, splits, vec, stream
WO_ARGTYPES = [I, I, P, P, P, P, P, P, P, I, I, I, I, I, I, I, P]

# ``replaces``: the JAX function whose XLA fusion the kernel stands for
# (file:line name), then "(no Pallas kernel: ...)"
_XLA = " (no Pallas kernel: an XLA fusion)"
WO_GEMM_KERNEL = register(CudaKernel(
    name="wo_gemm",
    source="csrc/wo_gemm.cu",
    symbol="wo_gemm_launch",
    argtypes=WO_ARGTYPES,
    replaces="semi_pd_tpu/layers/linear.py:30 apply_linear" + _XLA,
))
WO_GEMM_BLOCK_KERNEL = register(WO_GEMM_KERNEL.instantiation(
    "wo_gemm_block", "semi_pd_tpu/ops/quant/fp8.py:53 blockwise_fp8_matmul" + _XLA))
WO_GEMM_AWQ_KERNEL = register(WO_GEMM_KERNEL.instantiation(
    "wo_gemm_awq", "semi_pd_tpu/layers/linear.py:55 _awq_int4_matmul" + _XLA))
WO_GEMM_EXPERTS_KERNEL = register(WO_GEMM_KERNEL.instantiation(
    "wo_gemm_experts", "semi_pd_tpu/ops/moe.py:75 expert_weights" + _XLA))


def split_k(M: int, N: int, K: int, sms: int) -> int:
    """K splits of a dense product: enough blocks for two per SM where the
    output tiles give fewer, each split at least MIN_SPLIT_TILES K tiles."""
    blocks = -(-N // BN) * -(-M // BM)
    k_tiles = -(-K // BK)
    return max(1, min(-(-2 * sms // blocks), k_tiles // MIN_SPLIT_TILES))


def _b98(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: the weight-only dequant kernels take bf16 activations and fp8 e4m3 or "
        f"int8 weights; float32 serving with quantized weights and e5m2 weights are "
        f"ROADMAP B9.8")


def _launch(kernel: CudaKernel, x: torch.Tensor, w: torch.Tensor, ws: torch.Tensor,
            wz: Optional[torch.Tensor] = None, ends: Optional[torch.Tensor] = None,
            group: int = 0) -> torch.Tensor:
    """One launch of the C entry in ``kernel``'s mode; x [M, K] bf16, w
    [K, N] (or [E, K, N] with ``ends``, the groups' cumulative row ends)."""
    if not x.is_cuda:
        raise ValueError(f"{kernel.name}: x on {x.device}; CUDA tensors or the CPU")
    if x.dtype != torch.bfloat16:
        raise _b98(f"{kernel.name} with {x.dtype} activations")
    if w.dtype not in WTYPE:
        raise _b98(f"{kernel.name} with {w.dtype} weights")
    x, w, ws = x.contiguous(), w.contiguous(), ws.float().contiguous()
    M, K = x.shape
    N = w.shape[-1]
    if w.shape[-2] != K:
        raise ValueError(f"{kernel.name}: x [{M}, {K}] against w {tuple(w.shape)}")
    y = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if M == 0:
        return y
    E = w.shape[0] if ends is not None else 0
    splits = 1 if ends is not None else split_k(M, N, K, sm_count(x.device.index or 0))
    partial = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    vec = int(N % 16 == 0 and K % 8 == 0 and x.data_ptr() % 16 == 0
              and w.data_ptr() % 16 == 0)
    if wz is not None:
        wz = wz.contiguous()
    kernel.launch(MODE[kernel.name], WTYPE[w.dtype], x.data_ptr(), w.data_ptr(), ws.data_ptr(),
                  wz.data_ptr() if wz is not None else None,
                  ends.data_ptr() if ends is not None else None, y.data_ptr(),
                  partial.data_ptr() if partial is not None else None,
                  M, N, K, E, group, splits, vec, cuda_stream_ptr(x.device))
    return y


# ------------------------------------------------------------------ plain
def wo_gemm_plain(x: torch.Tensor, w: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """Per-channel fp8 / int8, the JAX order: ``dot(x, w.astype(x.dtype),
    float32)``, then x ws, then cast to x's dtype."""
    return (torch.matmul(x.float(), w.float()) * ws.float()).to(x.dtype)


def wo_gemm_block_plain(x: torch.Tensor, w: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """Blockwise fp8 (ops/quant/fp8.py blockwise_fp8_matmul)."""
    return blockwise_fp8_matmul(x, w, ws, 128)


def awq_dequant(w: torch.Tensor, ws: torch.Tensor, wz: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """(w - wz) * ws in float32 per group of din rows, cast to ``dtype``."""
    din, dout = w.shape
    g = din // ws.shape[-2]
    wf = w.float().reshape(din // g, g, dout)
    deq = (wf - wz.float()[:, None, :]) * ws.float()[:, None, :]
    return deq.reshape(din, dout).to(dtype)


def wo_gemm_awq_plain(x: torch.Tensor, w: torch.Tensor, ws: torch.Tensor,
                      wz: torch.Tensor) -> torch.Tensor:
    """AWQ int4 (``_awq_int4_matmul``): the weight dequantized in float32,
    rounded to x's dtype, then the product in float32, cast."""
    return torch.matmul(x.float(), awq_dequant(w, ws, wz, x.dtype).float()).to(x.dtype)


def expert_dequant(w: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """``expert_weights``: a quantized stack [.., E, K, N] times its
    per-channel scales [.., E, N] in float32, rounded to bf16."""
    return (w.float() * ws.float()[..., None, :]).to(torch.bfloat16)


def wo_gemm_experts_plain(x: torch.Tensor, w: torch.Tensor, ws: torch.Tensor,
                          group_sizes: torch.Tensor) -> torch.Tensor:
    """The stack dequantized to bf16, then the grouped product of the rows
    (sorted by expert, cast to bf16) in bf16."""
    from semi_pd_tpu_torch.ops.moe import grouped_matmul_plain

    return grouped_matmul_plain(x.to(torch.bfloat16), expert_dequant(w, ws), group_sizes)


# ------------------------------------------------------------------ wrappers
def wo_gemm(x: torch.Tensor, w: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """x [T, K] @ per-channel fp8 / int8 w [K, N] (scale ws [N]) -> [T, N]."""
    if x.device.type == "cpu":
        return wo_gemm_plain(x, w, ws)
    return _launch(WO_GEMM_KERNEL, x, w, ws)


def wo_gemm_block(x: torch.Tensor, w: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """x [T, K] @ blockwise fp8 w [K, N] (scales [ceil(K/128), ceil(N/128)])."""
    if x.device.type == "cpu":
        return wo_gemm_block_plain(x, w, ws)
    return _launch(WO_GEMM_BLOCK_KERNEL, x, w, ws)


def wo_gemm_awq(x: torch.Tensor, w: torch.Tensor, ws: torch.Tensor,
                wz: torch.Tensor) -> torch.Tensor:
    """x [T, K] @ AWQ int4 w [K, N] (int8 0..15; ws, wz [K/g, N])."""
    if x.device.type == "cpu":
        return wo_gemm_awq_plain(x, w, ws, wz)
    return _launch(WO_GEMM_AWQ_KERNEL, x, w, ws, wz=wz, group=w.shape[0] // ws.shape[0])


def wo_gemm_experts(x: torch.Tensor, w: torch.Tensor, ws: torch.Tensor,
                    group_sizes: torch.Tensor) -> torch.Tensor:
    """Rows of x [R, K] sorted by expert (``group_sizes`` [E] rows each, on
    the device) times their expert's quantized w[e] [K, N] -> bf16 [R, N]."""
    if x.device.type == "cpu":
        return wo_gemm_experts_plain(x, w, ws, group_sizes)
    ends = torch.cumsum(group_sizes, dim=0)  # int64 on the device: no host read
    return _launch(WO_GEMM_EXPERTS_KERNEL, x.to(torch.bfloat16), w, ws, ends=ends)


def _product(p: dict):
    """(wrapper, plain version, arguments after x) of a quantized linear's
    leaves ``p`` ({"w", "ws"[, "wz"]}), dispatched as JAX's ``apply_linear``:
    fp8 with block scales (ws of w's rank) -> ``wo_gemm_block``; int8 with
    zeros -> ``wo_gemm_awq``; fp8 or int8 per channel -> ``wo_gemm``."""
    w, ws = p["w"], p["ws"]
    if w.dtype in (torch.float8_e4m3fn, torch.float8_e5m2) and ws.dim() == w.dim():
        return wo_gemm_block, wo_gemm_block_plain, (w, ws)
    if w.dtype == torch.int8 and p.get("wz") is not None:
        return wo_gemm_awq, wo_gemm_awq_plain, (w, ws, p["wz"])
    return wo_gemm, wo_gemm_plain, (w, ws)


def quant_matmul(x: torch.Tensor, p: dict) -> torch.Tensor:
    """x [.., K] @ a quantized linear's leaves ``p`` -> [.., N]."""
    fn, _, args = _product(p)
    return fn(x.reshape(-1, x.shape[-1]), *args).reshape(*x.shape[:-1], p["w"].shape[-1])


def quant_matmul_plain(x: torch.Tensor, p: dict) -> torch.Tensor:
    """``quant_matmul``'s plain versions on any device (a comparison's
    reference on the card; the served path never calls it there)."""
    _, plain, args = _product(p)
    return plain(x.reshape(-1, x.shape[-1]), *args).reshape(*x.shape[:-1], p["w"].shape[-1])
