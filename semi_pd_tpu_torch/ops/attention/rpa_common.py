"""Shared helpers of the port's ragged paged attention wrappers: argument
checks before a pointer reaches a kernel, the per-layer K and V addresses
of either pool, and the page gather the plain versions use.

Three pool layouts (mem/pool.py): the chunked pool ``[L, S, CT, 128]`` (one
row of ``2*Hkv*D`` elements per slot, K of all heads then V), the aligned
(5D) pool ``[L, 2, S, Hkv, D]`` (K and V each in their own plane) and the
MLA latent pool ``[L, 1, S, 1, Dlat]`` (one latent row per slot; V is its
first ``v_dim`` elements). The kernels address all three through a K base,
a V base and one row stride (csrc/rpa_common.cuh); on the latent pool the V
base is the K base. The 5D pool below head_dim 128 has kernels of its own,
the "merged" family (the counterparts of the TPU kernel
_rpa_kernel_merged); at head_dim 128 and 256 (Gemma-2's) the "aligned"
family has a build each, as the latent family has one per latent width
(``pick_kernel``). ``spec_tree_mask`` is the speculation-tree mask the
extend kernels and their plain versions apply (``spec_anc``); ``alibi_bias``
ALiBi's bias (``alibi_slopes``), which the aligned head_dim-128 decode and
extend have in an instantiation of their own (``alibi_build``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from semi_pd_tpu_torch.speculative.tree import MAX_TREE_NODES

# argtypes pieces of the C entry points
P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)

# Element type codes of the C entry points (csrc/rpa_common.cuh TypeCode)
TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2,
              torch.float8_e5m2: 3}

# What each family of kernels is instantiated for (kernel_family): the
# head dims of the GQA families (one build per head_dim: the aligned
# family's 128 and, for Gemma-2, 256), and the (q, KV) dtype pairs of every
# build (csrc/rpa_common.cuh RPA_FOR_EACH_PAIR): fp8 KV (the latent rows on
# the latent pool) goes with bf16 q, widened exactly to bf16 inside the
# kernels
KERNEL_HEAD_DIMS = {"chunked": (64,), "aligned": (128, 256), "merged": (64,)}
KERNEL_PAIRS = frozenset({(torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
                          (torch.bfloat16, torch.float8_e4m3fn),
                          (torch.bfloat16, torch.float8_e5m2)})
# The latent pool's builds, one per geometry: latent width -> V's width (V
# is the row's first elements; csrc/rpa_mla.cuh RPA_MLA_DL / RPA_MLA_DV):
# DeepSeek-V2's 512 + 64 with V 512, MiniCPM3's 256 + 32 with V 256
LATENT_BUILDS = {576: 512, 288: 256}


def latent_defines(width: int) -> tuple:
    """The nvcc defines of the latent build of ``width`` (none at 576, the
    sources' default geometry)."""
    if width == 576:
        return ()
    return (f"RPA_MLA_DL={width}", f"RPA_MLA_DV={LATENT_BUILDS[width]}")


def aligned_defines(head_dim: int) -> tuple:
    """The nvcc defines of the aligned family's build at ``head_dim``
    (RPA_ALIGNED alone at 128, the sources' default)."""
    return ("RPA_ALIGNED",) if head_dim == 128 else ("RPA_ALIGNED", f"RPA_HEAD_DIM={head_dim}")


def pick_kernel(kernels: dict, kv_cache: torch.Tensor):
    """The build serving the pool from ``kernels`` (kernel_family -> kernel,
    or for a family with a build per width -> {width: kernel}: the aligned
    pool's head_dim, the latent pool's latent width). A width with no build
    gets the family's first one (the aligned 128, DeepSeek-V2's 576): the
    CPU runs the plain version at any width, and on the card check_cuda
    refuses the width before any launch."""
    k = kernels.get(kernel_family(kv_cache))
    return k.get(kv_cache.shape[-1], next(iter(k.values()))) if isinstance(k, dict) else k


def spec_tree_mask(valid: torch.Tensor, spec_anc, win_base, q_abs: torch.Tensor,
                   kv_pos: torch.Tensor) -> torch.Tensor:
    """Refine the causal mask ``valid`` with the static speculation-tree
    ancestor masks (port of semi_pd_tpu/ops/attention/rpa_common.py:61
    _spec_tree_mask): a KV position inside the window [win_base, win_base +
    W) stays visible to a query row only if the row's ancestor mask has its
    bit set; outside the window the causal mask stands. ``q_abs`` are
    SLOT-ORDER positions (window node index + win_base); a row outside the
    window has mask 0, as the TPU kernel's select chain gives. ``win_base``
    is an int or a tensor broadcasting against ``q_abs`` and ``kv_pos``."""
    W = len(spec_anc)
    anc = torch.as_tensor(list(spec_anc), dtype=torch.int64, device=q_abs.device)
    win_q = q_abs - win_base
    in_q = (win_q >= 0) & (win_q < W)
    bits = torch.where(in_q, anc[win_q.clamp(0, W - 1)], torch.zeros_like(win_q))
    win_kv = kv_pos - win_base
    in_win = (win_kv >= 0) & (win_kv < W)
    tree_ok = ((bits >> win_kv.clamp(0, 31)) & 1) > 0
    return valid & (~in_win | tree_ok)


def alibi_bias(alibi_slopes: torch.Tensor, num_kv_heads: int, q_pos: torch.Tensor,
               kv_pos: torch.Tensor) -> torch.Tensor:
    """ALiBi's float32 bias of the scores [rows, Hkv, G, n] of the plain
    versions: -slope[h G + g] * (q_pos - kv_pos), as the JAX reference adds
    it (semi_pd_tpu/ops/attention/reference.py:86-90), after the scale and
    the softcap and before the mask. ``q_pos`` [rows, 1] and ``kv_pos``
    [1, n] broadcast to the rows' distances."""
    dist = (q_pos - kv_pos).float()  # [rows, n]
    slopes = alibi_slopes.float().reshape(1, num_kv_heads, -1, 1)
    return -(slopes * dist[:, None, None, :])


def check_alibi(alibi_slopes, q: torch.Tensor, spec_anc=None, v_dim=None) -> None:
    """ALiBi's slopes: float32 [Hq] on q's device, contiguous; not with a
    speculation tree (ROADMAP B9.6) nor on the latent pool."""
    if alibi_slopes is None:
        return
    if spec_anc is not None:
        raise NotImplementedError("ALiBi with a speculation tree: the ALiBi instantiation has "
                                  "no tree (ROADMAP B9.6)")
    if v_dim is not None:
        raise ValueError("ALiBi on the latent pool: MLA attention takes no slopes")
    if (alibi_slopes.dtype != torch.float32 or alibi_slopes.shape != (q.shape[1],)
            or alibi_slopes.device != q.device or not alibi_slopes.is_contiguous()):
        raise ValueError(f"alibi_slopes must be float32 [{q.shape[1]}] on {q.device}, got "
                         f"{alibi_slopes.dtype} {tuple(alibi_slopes.shape)} on "
                         f"{alibi_slopes.device}")


def alibi_build(kernel, builds: dict):
    """The ALiBi instantiation of ``kernel`` (``builds``: build name -> its
    ALIBI instantiation, counted apart). Only the 5D pool's head_dim-128
    decode and extend have one (Baichuan2-13B's); any other build raises,
    naming ROADMAP B9.6."""
    if kernel.name not in builds:
        raise NotImplementedError(
            f"{kernel.name} has no ALiBi instantiation: only the 5D pool's head_dim-128 "
            f"builds have one (rpa_decode_aligned, rpa_extend_aligned); other builds are "
            f"ROADMAP B9.6")
    return builds[kernel.name]


def check_spec(spec_anc, win_base, batch: int) -> None:
    """The speculation-tree arguments: both or neither; at most
    MAX_TREE_NODES masks, each a positive int32 with its own bit set (a
    node sees itself); ``win_base`` int32 [B]."""
    if (spec_anc is None) != (win_base is None):
        raise ValueError("spec_anc and win_base go together")
    if spec_anc is None:
        return
    if not 0 < len(spec_anc) <= MAX_TREE_NODES:
        raise ValueError(f"a speculation tree has 1 to {MAX_TREE_NODES} nodes, "
                         f"got {len(spec_anc)}")
    for i, a in enumerate(spec_anc):
        if not 0 < int(a) < 2 ** 31 or not (int(a) >> i) & 1:
            raise ValueError(f"spec_anc[{i}] = {a}: a positive int32 with bit {i} set")
    if win_base.dtype != torch.int32 or win_base.shape != (batch,):
        raise ValueError(f"win_base must be int32 [{batch}], got {win_base.dtype} "
                         f"{tuple(win_base.shape)}")


def pool_layout(kv_cache: torch.Tensor) -> str:
    """"chunked" for [L, S, CT, 128], "aligned" for [L, 2, S, Hkv, D],
    "latent" for the MLA pool [L, 1, S, 1, Dlat]."""
    if kv_cache.dim() == 4 and kv_cache.shape[3] == 128:
        return "chunked"
    if kv_cache.dim() == 5 and kv_cache.shape[1] == 2:
        return "aligned"
    if kv_cache.dim() == 5 and kv_cache.shape[1] == 1 and kv_cache.shape[3] == 1:
        return "latent"
    raise ValueError(f"kv_cache must be the chunked pool [L, S, CT, 128], the "
                     f"aligned pool [L, 2, S, Hkv, D] or the latent pool "
                     f"[L, 1, S, 1, Dlat], got {tuple(kv_cache.shape)}")


def kernel_family(kv_cache: torch.Tensor) -> str:
    """Which kernels serve the pool: its layout, except that the 5D pool
    below head_dim 128 is "merged" (the JAX dispatcher sends every
    D % 128 != 0 batch on that pool to _rpa_kernel_merged,
    ragged_paged_attention.py:548-561)."""
    layout = pool_layout(kv_cache)
    if layout == "aligned" and kv_cache.shape[-1] % 128:
        return "merged"
    return layout


def pool_heads(kv_cache: torch.Tensor) -> Tuple[int, int]:
    """(Hkv, D) of the aligned pool, (1, Dlat) of the latent pool."""
    return kv_cache.shape[3], kv_cache.shape[4]


def check_pool_args(q, kv_cache, layer_idx, page_table, kv_lens, num_kv_heads,
                    head_dim, v_dim=None) -> Tuple[int, int, int]:
    """Validate what every wrapper passes on; returns (Hq, D, G). ``v_dim``
    (MLA: V is the first v_dim elements of the latent row) goes with the
    latent pool and only with it."""
    if q.dim() != 3:
        raise ValueError(f"q must be [rows, Hq, D], got {tuple(q.shape)}")
    _, Hq, D = q.shape
    if D != head_dim:
        raise ValueError(f"q head_dim {D} != head_dim {head_dim}")
    if num_kv_heads <= 0 or Hq % num_kv_heads:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={num_kv_heads}")
    layout = pool_layout(kv_cache)
    if (layout == "latent") != (v_dim is not None):
        raise ValueError(f"v_dim={v_dim} on the {layout} pool: MLA attention (v_dim) "
                         f"runs on the latent pool [L, 1, S, 1, Dlat] and only there")
    if layout == "latent" and not 0 < v_dim <= D:
        raise ValueError(f"v_dim {v_dim} outside the latent row's (0, {D}]")
    if layout == "chunked" and kv_cache.shape[2] * 128 != 2 * num_kv_heads * D:
        raise ValueError(f"pool rows hold {kv_cache.shape[2] * 128} elements, "
                         f"expected 2*Hkv*D = {2 * num_kv_heads * D}")
    if layout != "chunked" and pool_heads(kv_cache) != (num_kv_heads, D):
        raise ValueError(f"{layout} pool holds (Hkv, D) = {pool_heads(kv_cache)}, "
                         f"expected {(num_kv_heads, D)}")
    if not 0 <= int(layer_idx) < kv_cache.shape[0]:
        raise ValueError(f"layer {layer_idx} outside the pool's {kv_cache.shape[0]} layers")
    # fp8 KV is read widened, under bf16 q on the card and float32 q in the
    # plain versions
    fp8_ok = kv_cache.dtype in FP8 and q.dtype in (torch.bfloat16, torch.float32)
    if kv_cache.dtype != q.dtype and not fp8_ok:
        raise ValueError(f"q dtype {q.dtype} does not go with KV dtype {kv_cache.dtype} "
                         f"on the {layout} pool (KV in q's dtype, or fp8 under bf16 or "
                         f"float32 q)")
    if page_table.dtype != torch.int32 or kv_lens.dtype != torch.int32:
        raise ValueError("page_table and kv_lens must be int32")
    if page_table.dim() != 2 or kv_lens.shape != (page_table.shape[0],):
        raise ValueError(f"page_table [B, maxP] and kv_lens [B] disagree: "
                         f"{tuple(page_table.shape)} vs {tuple(kv_lens.shape)}")
    return Hq, D, Hq // num_kv_heads


def check_cuda(q, kv_cache, *ints, v_dim=None) -> None:
    """Everything a kernel reads or writes: one CUDA device, contiguous, a
    head_dim (and on the latent pool a v_dim) and (q, KV) dtype pair the
    pool's kernel family was built for, and 16-byte aligned where the
    kernel reads 16-byte vectors (q, the pool). The int32 arrays are read
    element by element and may be views into the packed step vector."""
    dev = q.device
    for t in (q, kv_cache, *ints):
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    if q.data_ptr() % 16 or kv_cache.data_ptr() % 16:
        raise ValueError("q and the KV pool must be 16-byte aligned")
    family = kernel_family(kv_cache)
    if (q.dtype, kv_cache.dtype) not in KERNEL_PAIRS:
        raise ValueError(f"the {family} kernels take (q, KV) dtypes "
                         f"{sorted(map(str, KERNEL_PAIRS))}, got "
                         f"({q.dtype}, {kv_cache.dtype})")
    if family == "latent":
        if LATENT_BUILDS.get(q.shape[-1]) != v_dim:
            raise NotImplementedError(
                f"latent width {q.shape[-1]} with v_dim {v_dim}: the latent pool's "
                f"kernels are built for (width, v_dim) {sorted(LATENT_BUILDS.items())} "
                f"(DeepSeek-V2's, MiniCPM3's); other MLA geometries are ROADMAP B9.4")
    elif q.shape[-1] not in KERNEL_HEAD_DIMS[family]:
        raise NotImplementedError(
            f"head_dim {q.shape[-1]}: the {family} kernels are built for head_dim "
            f"{', '.join(map(str, KERNEL_HEAD_DIMS[family]))}; other head dims are ROADMAP A9 "
            f"(their builds B9.4)")


def kv_planes(kv_cache: torch.Tensor, layer_idx: int, num_kv_heads: int,
              head_dim: int) -> Tuple[int, int, int]:
    """(K address, V address, row stride in elements) of layer
    ``layer_idx``: K and V of slot s, head h sit at base + (s * row_stride
    + h * D) elements. Computed in Python ints: a full pool can exceed
    2**31 elements. The kernels' 16-byte loads stay aligned for every KV
    dtype, fp8 included: at the head dims they are built for (64, 128, 256,
    and the latent 576 and 288)
    the V offset, the row stride and a head's offset are multiples of 16
    bytes (on the chunked pool at Hkv 8, D 64 and fp8, V sits 512 bytes into
    the slot's 1024-byte row)."""
    esz = kv_cache.element_size()
    if pool_layout(kv_cache) == "chunked":
        L, S, CT, W = kv_cache.shape
        k = kv_cache.data_ptr() + int(layer_idx) * S * CT * W * esz
        return k, k + num_kv_heads * head_dim * esz, CT * W
    L, ncomp, S, Hkv, D = kv_cache.shape
    plane = S * Hkv * D * esz
    k = kv_cache.data_ptr() + int(layer_idx) * ncomp * plane
    # the latent pool's V is the prefix of its one row
    return k, (k + plane if ncomp == 2 else k), Hkv * D


def layer_kv(kv_cache: torch.Tensor, layer_idx: int, num_kv_heads: int, head_dim: int,
             v_dim=None):
    """K and V of layer ``layer_idx`` of any pool, as [S, Hkv, D] and
    [S, Hkv, Dv] views (on the latent pool V is K's first v_dim elements)."""
    layout = pool_layout(kv_cache)
    if layout == "chunked":
        S = kv_cache.shape[1]
        kv = kv_cache[int(layer_idx)].reshape(S, 2, num_kv_heads, head_dim)
        return kv[:, 0], kv[:, 1]
    k = kv_cache[int(layer_idx), 0]
    if layout == "latent":
        return k, k[..., :v_dim]
    return k, kv_cache[int(layer_idx), 1]


def gather_kv(k_layer: torch.Tensor, v_layer: torch.Tensor, pt_row: torch.Tensor,
              n: int, page_size: int):
    """K and V of positions [0, n) of one request, as float32 [n, Hkv, D]
    and [n, Hkv, Dv], read page by page through the request's page-table
    row from a layer's views (``layer_kv``)."""
    pos = torch.arange(n, device=k_layer.device)
    slots = pt_row.long()[pos // page_size] * page_size + pos % page_size
    return k_layer[slots].float(), v_layer[slots].float()
