"""Card-only tests of the port: each CUDA kernel against its plain PyTorch
version (the streaming decodes, the tensor-core extends and the tensor-core
decode also against themselves, bitwise, on a second run; the tensor-core
extend with 1, 2, 4 and 8 query heads per KV head, the latent extend's
warpgroup kernel over several entries per request, the tensor-core decode
of every build split over blocks at long KV and refusing an invalid
split plan, the streaming decodes over batches whose requests the
tensor-core stream cuts across warps and blocks, with every slot past
kv_len set to NaN, the tensor-core stream refusing an invalid plan, and
the libraries disassembled for HMMA instructions), the
CUDA MoE path (torch._grouped_mm) against its plain loop, and the Engine
on its default CUDA device against the same Engine on the CPU (Llama on
the chunked, the aligned and the merged 5D pool at head_dim 64, with and
without the streaming decode; DeepSeek-V2 on the latent pool; in bf16
with fp8 KV on the chunked and the latent pool, greedy tokens equal up to
a near tie), and the decode steps replayed from CUDA graphs against the
eager step, bitwise, on each decode path, the fp8 ones included (with no
host sync in either); the four extends with a speculation tree's masks
(the MLA one's TREE and tree-less instantiations on the same inputs), and
the speculating Engines (NGRAM, EAGLE chain and tree on a Llama target,
NEXTN chain and tree on a DeepSeek-V2 one) against the CPU; the three
_256 builds at Gemma-2's head_dim 256 (decode, stream and extend against
their plain versions with softcap and window, every dead slot NaN, the
stream's requests cut across warps and blocks, the extend at 1, 2 and 4
query heads per KV head, their tensor-core instructions, the extend's
refusal of a tree) and a small Gemma-2 Engine, packed and streamed, against
the CPU; the aligned and _256 builds at 1 and 8 query heads per KV head,
Engines of the Llama-family strings, Gemma-1 and the GQA MoE families
against the CPU and a MoE decode step with 60 experts replayed bitwise;
and the speculating rounds replayed from round graphs against the
eager round, bitwise, pools included (EAGLE chain and tree, NextN chain and
tree, NGRAM's verify; a small target and the pool geometry of each
full-width speculating path), with no host sync in a replay, the
speculating Engine on round graphs against its eager serve, and a round
whose capture fails raising; the decode step variants (a grammar mask, a
logit bias, penalties, a top-k, and all at once) replayed bitwise against
their eager steps, the plain key unchanged beside them, and a constrained
batch served on graphs as eagerly; the ALiBi instantiations of the aligned
decode and extend against their plain versions (one and four query heads
per KV head, with a softcap, a prefix hit and two-entry prompts), their
refusal on the other builds and the stream, the aligned builds at 6 and
16 query heads per KV head, the float32 decodes' refusal at G = 16, the
merged builds at 36 KV heads, and Engines of the Llama-variant forwards
(Baichuan's ALiBi, MiniCPM, ChatGLM, Glm4, DeepSeek-V1, Grok-1, Granite)
against the CPU; the GQA decodes and streams in head groups past 16
query heads a KV head (StarCoder's 48 / 1, Falcon-7B's 71 / 1 over a
64-element slot row, G = 17 and 20), with the extends at those G, over
long KV (splits, streams cut across blocks) and with ALiBi, the float32
decodes' refusal there, and Engines of the LayerNorm families (StableLM,
Starcoder2, Phi, Cohere, OLMo-2, Phi-3-small, GPT-2, GPT-BigCode, OLMo-1,
Falcon, DBRX) against the CPU. Every kernel is held with each (q, KV) pair it is
built for, fp8 e4m3 and e5m2 under bf16 q included. This file
imports no JAX, so it also runs on a machine with a GPU and no JAX:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Without a CUDA device every test skips.

Tolerances: float32 1e-4 (online vs full softmax, another summation order);
bfloat16 1e-2, also with fp8 KV, where kernel and plain version read the
same fp8 bytes: the chunked and the aligned kernels round P to bf16 before
P.V, as the GQA branches of the TPU kernels do, and 1e-2 absorbs that one
rounding (test_bf16_gqa_decodes_round_p and test_bf16_gqa_extends_round_p
show that the decodes and the extends round it).
The merged and the MLA kernels keep P in float32, as the TPU
kernels they replace do, so with bf16 q they are also held closer
(test_bf16_kernels_keep_p_float32): at least 99% of their outputs bitwise
equal to the plain version's and none more than one bf16 step away, a
share that the plain version with P rounded to bf16 misses on the same
inputs. The softcap of 1.0 bends most scores, whose std is about 1 here.
MoE in bf16: 2e-2 relative to the output's scale (both paths round the
same bf16 products; the grouped GEMM sums K in another order).
"""

import functools

import numpy as np
import pytest
import torch

from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.config.server_args import ServerArgs
from semi_pd_tpu_torch.kernels import KERNELS
from semi_pd_tpu_torch.ops import moe
from semi_pd_tpu_torch.ops.attention import ragged_paged_attention as rpa
from semi_pd_tpu_torch.ops.attention import rpa_common, rpa_packed, rpa_stream
from semi_pd_tpu_torch.runtime.engine import Engine
from semi_pd_tpu_torch.runtime.forward_batch import AttnMeta, build_attn_meta
from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams

HQ, HKV, D, PS, L = 8, 2, 64, 16, 2
D_ALIGNED = 128
# the latent pool's kernels: DeepSeek-V2's latent row (512 + 64), V = 512
HQ_MLA, DLAT, V_DIM = 16, 576, 512


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _unaligned(a: np.ndarray, dev) -> torch.Tensor:
    """An int32 tensor that is a view at a 4-byte (not 16-byte) offset, as
    the runner's slices of the packed step vector are."""
    buf = torch.zeros(a.size + 1, dtype=torch.int32, device=dev)
    view = buf[1:].view(a.shape)
    view.copy_(torch.from_numpy(np.ascontiguousarray(a, np.int32)))
    return view


def _case(seed, q_lens, kv_lens, dev, dtype, pad_T=0, pad_B=0, aligned=False,
          kv_dtype=None, latent=False, merged=False, hq=HQ, hkv=HKV, dlat=DLAT,
          hq_mla=HQ_MLA, aligned_dim=D_ALIGNED):
    """Queries, a pool (chunked [L, S, CT, 128], aligned [L, 2, S, Hkv,
    aligned_dim] (128, or Gemma-2's 256), merged [L, 2, S, Hkv, 64] or
    latent [L, 1, S, 1, dlat], in ``kv_dtype``, default ``dtype``; ``hq``
    query and ``hkv`` KV heads outside the latent pool, ``hq_mla`` on it)
    and a shuffled page table."""
    rng = np.random.default_rng(seed)
    B = len(kv_lens) + pad_B
    n_pages = [-(-k // PS) for k in kv_lens]
    total = sum(n_pages) + 2
    perm = rng.permutation(np.arange(1, total))
    pt = np.zeros((B, max(n_pages) + 1), np.int32)
    used = 0
    for b, n in enumerate(n_pages):
        pt[b, :n] = perm[used:used + n]
        used += n
    T = sum(q_lens) + pad_T
    ql = np.zeros(B, np.int32)
    ql[: len(q_lens)] = q_lens
    kl = np.zeros(B, np.int32)
    kl[: len(kv_lens)] = kv_lens
    d = aligned_dim if aligned else D
    shape = (L, 2, total * PS, hkv, d) if aligned else (L, total * PS, 2 * hkv * D // 128, 128)
    if merged:
        shape = (L, 2, total * PS, hkv, D)
    scale = 1.0
    if latent:
        d, hq, shape = dlat, hq_mla, (L, 1, total * PS, 1, dlat)
        # scores q.k * dlat**-0.5 of std ~1, as at the other widths
        scale = 0.3 if dlat == DLAT else 0.35
    pool = torch.from_numpy(rng.normal(size=shape).astype(np.float32) * scale)
    q = torch.from_numpy(rng.normal(size=(T, hq, d)).astype(np.float32) * scale)
    m = build_attn_meta(ql, kl, T)
    meta = AttnMeta(*[_unaligned(a.numpy(), dev) for a in m])
    return (q.to(dev, dtype), pool.to(dev, kv_dtype or dtype), _unaligned(pt, dev),
            _unaligned(kl, dev), meta)


def _decode_case(dev, dtype, **kw):
    return _case(7, [1] * 6, [33, 0, 260, 9, 77, 1], dev, dtype, **kw)


def _extend_case(dev, dtype, **kw):
    return _case(7, [140, 20, 1, 7], [140, 60, 9, 300], dev, dtype, pad_T=9, pad_B=1,
                 **kw)


def _many_case(dev, dtype, **kw):
    """200 decode rows (kv_len 0 to 300, some 0): more rows than the
    streaming decode's persistent grid has blocks, so a block streams
    several requests in a row."""
    lens = np.random.default_rng(8).integers(0, 301, size=200)
    lens[::17] = 0
    return _case(9, [1] * 200, lens.tolist(), dev, dtype, **kw)


def _opts(opt, scale):
    return dict(page_size=PS, scale=scale,
                logit_cap=1.0 if opt == "softcap" else None,
                sliding_window=24 if opt == "window" else None)


FP8 = {"fp8_e4m3": torch.float8_e4m3fn, "fp8_e5m2": torch.float8_e5m2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "fp8_e4m3", "fp8_e5m2"])
@pytest.mark.parametrize("kind", ["decode", "extend"])
@pytest.mark.parametrize("opt", ["plain", "softcap", "window"])
def test_kernel_matches_plain(cuda_device, kind, dtype, opt):
    """The chunked pool's kernels (head_dim 64; fp8 = bf16 q over an fp8
    pool) against their plain versions, on layer 1 of the pool: the decode
    with a padded row, the extend with q_len 140 over two work-list
    entries."""
    dt = torch.float32 if dtype == "float32" else torch.bfloat16
    case = _decode_case if kind == "decode" else _extend_case
    q, pool, pt, kvl, meta = case(cuda_device, dt, kv_dtype=FP8.get(dtype, dt))
    kw = dict(_opts(opt, 0.125), num_kv_heads=HKV, head_dim=D)
    k = KERNELS["rpa_" + kind]
    before = k.launches
    if kind == "decode":
        out = rpa_packed.ragged_paged_attention_chunked_packed(q, pool, 1, pt, kvl, **kw)
        ref = rpa_packed.decode_attention_plain(q, pool, 1, pt, kvl, **kw)
    else:
        out = rpa.ragged_paged_attention_chunked_extend(q, pool, 1, pt, kvl, meta, **kw)
        ref = rpa.extend_attention_plain(q, pool, 1, pt, kvl, meta, **kw)
    torch.cuda.synchronize()
    assert k.launches == before + 1
    tol = 1e-4 if dt == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "fp8_e4m3"])
@pytest.mark.parametrize("kind", ["decode", "extend"])
@pytest.mark.parametrize("opt", ["plain", "softcap", "window"])
def test_aligned_kernel_matches_plain(cuda_device, kind, dtype, opt):
    """The aligned pool's kernels (head_dim 128; fp8_e4m3 = bf16 q over an
    fp8 pool) against their plain versions, on layer 1 of the pool."""
    dt = torch.float32 if dtype == "float32" else torch.bfloat16
    kv_dt = torch.float8_e4m3fn if dtype == "fp8_e4m3" else dt
    case = _decode_case if kind == "decode" else _extend_case
    q, pool, pt, kvl, meta = case(cuda_device, dt, aligned=True, kv_dtype=kv_dt)
    kw = _opts(opt, D_ALIGNED ** -0.5)
    k = KERNELS[f"rpa_{kind}_aligned"]
    before = k.launches
    if kind == "decode":
        out = rpa_packed.ragged_paged_attention_packed(q, pool, 1, pt, kvl, **kw)
        ref = rpa_packed.ragged_paged_attention_packed_plain(q, pool, 1, pt, kvl, **kw)
    else:
        out = rpa.ragged_paged_attention_extend(q, pool, 1, pt, kvl, meta, **kw)
        ref = rpa.ragged_paged_attention_extend_plain(q, pool, 1, pt, kvl, meta, **kw)
    torch.cuda.synchronize()
    assert k.launches == before + 1
    tol = 1e-4 if dt == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "fp8_e4m3", "fp8_e5m2"])
@pytest.mark.parametrize("kind", ["decode", "extend"])
@pytest.mark.parametrize("opt", ["plain", "softcap", "window"])
def test_mla_kernel_matches_plain(cuda_device, kind, dtype, opt):
    """The latent pool's kernels (DeepSeek-V2's 576-wide latent row, V its
    first 512 elements, 16 query heads; fp8 = bf16 q over fp8 latent rows)
    against their plain versions, on layer 1 of the pool; the extend case
    has q_len 140 > 128 (two work-list entries for one request) and a
    padded batch row."""
    dt = torch.float32 if dtype == "float32" else torch.bfloat16
    case = _decode_case if kind == "decode" else _extend_case
    q, pool, pt, kvl, meta = case(cuda_device, dt, latent=True, kv_dtype=FP8.get(dtype, dt))
    kw = dict(_opts(opt, DLAT ** -0.5), v_dim=V_DIM)
    k = KERNELS[f"rpa_{kind}_mla"]
    before = k.launches
    if kind == "decode":
        out = rpa_packed.ragged_paged_attention_packed(q, pool, 1, pt, kvl, **kw)
        ref = rpa_packed.ragged_paged_attention_packed_plain(q, pool, 1, pt, kvl, **kw)
    else:
        out = rpa.ragged_paged_attention_extend(q, pool, 1, pt, kvl, meta, **kw)
        ref = rpa.ragged_paged_attention_extend_plain(q, pool, 1, pt, kvl, meta, **kw)
    torch.cuda.synchronize()
    assert k.launches == before + 1
    assert out.shape == ref.shape == (q.shape[0], HQ_MLA, V_DIM)
    tol = 1e-4 if dt == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "fp8_e4m3", "fp8_e5m2"])
@pytest.mark.parametrize("kind", ["decode", "extend"])
@pytest.mark.parametrize("opt", ["plain", "softcap", "window"])
def test_merged_kernel_matches_plain(cuda_device, kind, dtype, opt):
    """The merged kernels (the 5D pool at head_dim 64, TinyLlama's path;
    fp8 = bf16 q over an fp8 pool) against their plain versions, on layer 1
    of the pool, for every type pair they are built for."""
    dt = torch.float32 if dtype == "float32" else torch.bfloat16
    case = _decode_case if kind == "decode" else _extend_case
    q, pool, pt, kvl, meta = case(cuda_device, dt, merged=True,
                                  kv_dtype=FP8.get(dtype, dt))
    kw = _opts(opt, D ** -0.5)
    k = KERNELS[f"rpa_{kind}_merged"]
    before = k.launches
    if kind == "decode":
        out = rpa_packed.ragged_paged_attention_packed(q, pool, 1, pt, kvl, **kw)
        ref = rpa_packed.ragged_paged_attention_packed_plain(q, pool, 1, pt, kvl, **kw)
    else:
        out = rpa.ragged_paged_attention_extend(q, pool, 1, pt, kvl, meta, **kw)
        ref = rpa.ragged_paged_attention_extend_plain(q, pool, 1, pt, kvl, meta, **kw)
    torch.cuda.synchronize()
    assert k.launches == before + 1
    tol = 1e-4 if dt == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


# The tensor-core extend (bf16 q): the G = Hq / Hkv query heads of a KV head
# are packed into the rows of its m16 tiles. Hkv for each G at Hq 8.
GROUPS = {1: 8, 2: 4, 4: 2, 8: 1}
MMA_POOLS = {  # pool: (case options, kernel, head_dim, KV dtypes under bf16 q)
    "chunked": ({}, "rpa_extend", D, ["bfloat16", "fp8_e4m3", "fp8_e5m2"]),
    "aligned": ({"aligned": True}, "rpa_extend_aligned", D_ALIGNED,
                ["bfloat16", "fp8_e4m3", "fp8_e5m2"]),
    "merged": ({"merged": True}, "rpa_extend_merged", D,
               ["bfloat16", "fp8_e4m3", "fp8_e5m2"]),
    # the latent pool's warpgroup kernel: 16 query heads per latent row
    "latent": ({"latent": True}, "rpa_extend_mla", DLAT, ["bfloat16", "fp8_e4m3", "fp8_e5m2"]),
}
MMA_CASES = [(pool, kv) for pool, spec in MMA_POOLS.items() if pool != "latent"
             for kv in spec[3]]
MMA_IDS = [f"{pool}-{kv}" for pool, kv in MMA_CASES]
# the tensor-core extends, the latent pool's included
LATENT_KV = MMA_POOLS["latent"][3]
TC_CASES = MMA_CASES + [("latent", kv) for kv in LATENT_KV]
TC_IDS = MMA_IDS + [f"latent-{kv}" for kv in LATENT_KV]
MMA_Q_LENS = [140, 20, 1, 7, 300]  # rows of the real requests; 9 padding rows follow


def _mma_extend(dev, pool, kv, G, opt="plain"):
    """The tensor-core extend's inputs on layer 1 of the pool, with q_lens
    that are no multiple of 16 and span several 128-row entries, kv_lens
    that are no multiple of 64, and bucket padding (9 rows, one batch
    row); returns (inputs, kernel call, plain call, kernel name)."""
    extra, name, width, _ = MMA_POOLS[pool]
    bf = torch.bfloat16
    q, kv_t, pt, kvl, meta = _case(11, MMA_Q_LENS, [203, 83, 1, 70, 365], dev, bf, pad_T=9,
                                   pad_B=1, kv_dtype=FP8.get(kv, bf), hkv=GROUPS[G], **extra)
    kw = _opts(opt, width ** -0.5)
    if pool == "latent":
        kw["v_dim"] = V_DIM
    if pool == "chunked":
        kw.update(num_kv_heads=GROUPS[G], head_dim=D)
        kern, plain = rpa.ragged_paged_attention_chunked_extend, rpa.extend_attention_plain
    else:
        kern = rpa.ragged_paged_attention_extend
        plain = rpa.ragged_paged_attention_extend_plain
    args = (q, kv_t, 1, pt, kvl, meta)
    return q, (lambda: kern(*args, **kw)), (lambda: plain(*args, **kw)), name


@pytest.mark.parametrize("opt", ["plain", "softcap", "window"])
@pytest.mark.parametrize("G", sorted(GROUPS))
@pytest.mark.parametrize("pool,kv", MMA_CASES, ids=MMA_IDS)
def test_extend_tensor_cores_match_plain(cuda_device, pool, kv, G, opt):
    """The chunked, the aligned and the merged extend with bf16 q (the
    tensor-core kernel; bf16, fp8 e4m3 and e5m2 KV; P split into two bf16
    parts in the merged build) against their plain versions, with 1, 2, 4
    and 8 query heads per KV head."""
    _, kern, plain, name = _mma_extend(cuda_device, pool, kv, G, opt)
    k = KERNELS[name]
    before = k.launches
    out = kern()
    ref = plain()
    torch.cuda.synchronize()
    assert k.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("kv", LATENT_KV)
@pytest.mark.parametrize("opt", ["plain", "softcap", "window"])
def test_mla_extend_warpgroups_match_plain(cuda_device, opt, kv):
    """The latent pool's extend with bf16 q (the warpgroup kernel: 4 tokens
    x 16 heads per 64-row tile, S split over two warpgroups, P kept float32
    as hi + lo; fp8 rows widened through registers) against its plain
    version, at q_lens that span several 128-row entries and leave tiles of
    4 tokens partly owned."""
    _, kern, plain, name = _mma_extend(cuda_device, "latent", kv, 4, opt)
    k = KERNELS[name]
    before = k.launches
    out = kern()
    ref = plain()
    torch.cuda.synchronize()
    assert k.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("pool,kv", TC_CASES, ids=TC_IDS)
def test_extend_tensor_cores_repeat_bitwise(cuda_device, pool, kv):
    """Two calls on the same inputs give bitwise equal outputs: each block
    walks its tiles in a fixed order and nothing is summed with atomics."""
    _, kern, _, _ = _mma_extend(cuda_device, pool, kv, 4)
    first = kern()
    assert torch.equal(kern(), first)


@pytest.mark.parametrize("pool,kv", TC_CASES, ids=TC_IDS)
def test_extend_tensor_cores_leave_unowned_rows_zero(cuda_device, pool, kv):
    """The bucket-padding rows, which no work-list entry owns, stay 0,
    while every owned row is written (none of them is 0 here)."""
    q, kern, _, _ = _mma_extend(cuda_device, pool, kv, 4)
    out = kern()
    T = sum(MMA_Q_LENS)
    width = V_DIM if pool == "latent" else q.shape[2]
    assert out.shape == (*q.shape[:2], width) and not out[T:].any()
    assert out[:T].abs().amax(dim=(1, 2)).gt(0).all()


def _widen_every_fp8_value(dev, kv, head_dim):
    """The 5D pool's extend at head_dim (the aligned build at 128, the
    merged one at 64) over fp8 KV whose V rows hold the 256 byte patterns,
    head_dim to a row, one query row per V row; see the tests below."""
    G = 4
    dt = FP8[kv]
    n = 256 // head_dim
    pool = torch.zeros((1, 2, 2 * PS, 1, head_dim), dtype=dt, device=dev)
    k = torch.zeros((n, head_dim), device=dev)
    k[range(n), range(n)] = 448.0
    pool[0, 0, PS:PS + n, 0] = k.to(dt)
    pool[0, 1, PS:PS + n, 0] = (torch.arange(256, dtype=torch.uint8, device=dev)
                                .view(dt).reshape(n, head_dim))
    q = torch.zeros((n, G, head_dim), dtype=torch.bfloat16, device=dev)
    for r in range(n):
        q[r, :, r] = 448.0
    pt = torch.ones((1, 1), dtype=torch.int32, device=dev)  # page 1
    kvl = torch.tensor([n], dtype=torch.int32, device=dev)
    meta = build_attn_meta(np.array([n]), np.array([n]), n, device=dev)
    kw = _opts("plain", head_dim ** -0.5)
    out = rpa.ragged_paged_attention_extend(q, pool, 0, pt, kvl, meta, **kw)
    ref = rpa.ragged_paged_attention_extend_plain(q, pool, 0, pt, kvl, meta, **kw)
    v = pool[0, 1, PS:PS + n, 0].to(torch.bfloat16)
    torch.testing.assert_close(out, ref, rtol=0, atol=0, equal_nan=True)
    finite = torch.isfinite(v).all(dim=0)
    assert int(finite.sum()) >= head_dim - 8
    for r in range(n):
        # row r sees positions 0 .. r: its own one at weight 1, the others 0
        assert torch.equal(out[r][:, finite], v[r][finite].expand(G, -1))


@pytest.mark.parametrize("kv", ["fp8_e4m3", "fp8_e5m2"])
def test_aligned_extend_widens_every_fp8_value_exactly(cuda_device, kv):
    """The aligned extend widens fp8 KV to bf16 exactly, as the TPU kernel
    upcasts it, for all 256 byte values: V rows 0 and 1 hold the patterns
    0-127 and 128-255, keys and queries are one-hot at 448, so each query
    row's score at its own position is ~1.8e4 above the other's and that
    weight underflows to 0 in both versions: output row r is V row r in
    bf16 wherever both rows are finite (0 times a NaN or Inf pattern is NaN
    in the kernel as in the plain version, which it equals bitwise)."""
    _widen_every_fp8_value(cuda_device, kv, D_ALIGNED)


@pytest.mark.parametrize("kv", ["fp8_e4m3", "fp8_e5m2"])
def test_merged_extend_widens_every_fp8_value_exactly(cuda_device, kv):
    """As the aligned test above, at head_dim 64 (the merged build, whose
    fp8 producer maps its threads to the raw vectors differently, and which
    splits P into hi + lo: here P is 1 or 0, so lo is 0): V rows 0-3 hold
    the byte patterns 0-63, 64-127, 128-191 and 192-255, and output row r
    is V row r in bf16 wherever the columns are finite."""
    _widen_every_fp8_value(cuda_device, kv, D)


def test_extend_builds_run_on_the_tensor_cores(cuda_device):
    """The disassembled libraries: every bf16-q instantiation (bf16, e4m3
    and e5m2 KV) of the chunked, the aligned, the merged and the latent
    extend and decode runs tensor-core instructions (HGMMA in the extends'
    warpgroup kernels, HMMA in the decodes'); their float32 pairs stay on
    the CUDA cores. The four extends hold each kernel twice: with a
    speculation tree (TREE) and without; the aligned decode and extend
    hold each once more, as its ALiBi instantiation (ALIBI); every GQA
    decode's tensor-core kernel twice, with head groups past 16 query heads
    a KV head (GROUPS) and without."""
    from semi_pd_tpu_torch.kernels import sass_mma_counts

    expect = {  # library: (tensor-core kernel, CUDA-core kernel, bf16-q pairs, float32 ones)
        "rpa_extend": ("rpa_extend_wgmma_kernel", "rpa_extend_kernel", 6, 2),
        "rpa_extend_aligned": ("rpa_extend_wgmma_kernel", "rpa_extend_kernel", 9, 3),
        "rpa_extend_mla": ("rpa_extend_mla_wgmma_kernel", "rpa_extend_mla_kernel", 6, 2),
        "rpa_extend_merged": ("rpa_extend_wgmma_kernel", "rpa_extend_kernel", 6, 2),
        "rpa_decode": ("rpa_decode_mma_kernel", "rpa_decode_kernel", 6, 1),
        "rpa_decode_aligned": ("rpa_decode_mma_kernel", "rpa_decode_kernel", 12, 2),
        "rpa_decode_merged": ("rpa_decode_mma_kernel", "rpa_decode_kernel", 6, 1),
        "rpa_decode_mla": ("rpa_decode_mla_mma_kernel", "rpa_decode_mla_kernel", 3, 1),
    }
    for name, (mma_fn, core_fn, n_mma, n_core) in expect.items():
        KERNELS[name].fn()
        counts = sass_mma_counts(KERNELS[name])
        mma = [n for f, n in counts.items() if mma_fn in f]
        assert len(mma) == n_mma and all(mma), (name, counts)
        if "wgmma" in mma_fn:
            hgmma = sass_mma_counts(KERNELS[name], op="HGMMA")
            assert all(hgmma[f] == n for f, n in counts.items() if mma_fn in f), (name, counts)
        core = [n for f, n in counts.items() if core_fn in f]
        assert len(core) == n_core and not any(core), (name, counts)


def _bf16_steps(out: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """|out - ref| in bf16 steps, element by element, each step taken at the
    larger of |ref| and 2^-8 of the largest |ref| of its head's output
    vector. Below that, cancellation leaves float32's own rounding several
    steps of the element wide: at these inputs the plain version run in
    float64 lies up to 20 bf16 steps from the float32 one, on elements
    under 1e-6 (fidelity_witness.py)."""
    r = ref.float()
    a = torch.maximum(r.abs(), r.abs().amax(dim=-1, keepdim=True) * 2.0 ** -8)
    step = torch.exp2(torch.floor(torch.log2(a)) - 7)  # bf16 spacing at a; 0 at a == 0
    diff = (out.float() - r).abs()
    return torch.where(diff == 0, torch.zeros_like(diff), diff / step)


# (kind, pool, G, KV dtype): the merged kernels at TinyLlama's G = 8 (bf16
# and fp8_e4m3 KV) and at G = 4, and the MLA kernels (G = Hq = 16 query heads
# per latent row)
P_F32_CASES = [(kind, "merged", G, kv) for kind in ("decode", "extend")
               for G, kv in ((4, "bfloat16"), (8, "bfloat16"), (8, "fp8_e4m3"))]
P_F32_CASES += [(kind, "latent", HQ_MLA, "bfloat16") for kind in ("decode", "extend")]


@pytest.mark.parametrize("kind,pool,G,kv", P_F32_CASES,
                         ids=[f"{k}-{p}-G{g}-{kv}" for k, p, g, kv in P_F32_CASES])
def test_bf16_kernels_keep_p_float32(cuda_device, monkeypatch, kind, pool, G, kv):
    """With bf16 q, the merged and the MLA kernels keep P in float32, as the
    TPU kernels they replace do (_rpa_kernel_merged upcasts q, K and V, the
    MLA branches q and the latent rows): at least 99% of their bf16 outputs
    are bitwise equal to the plain version's, which computes in float32 and
    rounds once at the end, and none is more than one bf16 step away
    (_bf16_steps: near 0, a step at 2^-8 of the head's largest output). The
    same plain version with P rounded to bf16 before P.V, as a kernel that
    rounds P computes, stays below that share on the same inputs: the test
    sees a rounded P. With fp8 KV both read the same fp8 bytes, widened
    exactly. A second kernel call is bitwise equal."""
    bf = torch.bfloat16
    case = _decode_case if kind == "decode" else _extend_case
    extra = {"latent": True} if pool == "latent" else {"merged": True, "hkv": HQ // G}
    q, kv, pt, kvl, meta = case(cuda_device, bf, kv_dtype=FP8.get(kv, bf), **extra)
    kw = _opts("plain", (DLAT if pool == "latent" else D) ** -0.5)
    if pool == "latent":
        kw["v_dim"] = V_DIM
    if kind == "decode":
        kern = lambda: rpa_packed.ragged_paged_attention_packed(q, kv, 1, pt, kvl, **kw)
        plain = lambda: rpa_packed.ragged_paged_attention_packed_plain(q, kv, 1, pt, kvl, **kw)
    else:
        kern = lambda: rpa.ragged_paged_attention_extend(q, kv, 1, pt, kvl, meta, **kw)
        plain = lambda: rpa.ragged_paged_attention_extend_plain(q, kv, 1, pt, kvl, meta,
                                                                **kw)
    out = kern()
    ref = plain()
    torch.cuda.synchronize()
    assert torch.equal(kern(), out)
    share = float((out == ref).float().mean())
    steps = float(_bf16_steps(out, ref).max())
    assert steps <= 1 and share >= 0.99, (steps, share)
    softmax = torch.softmax
    monkeypatch.setattr(torch, "softmax",
                        lambda x, dim: softmax(x, dim=dim).to(bf).float())
    rounded = float((plain() == ref).float().mean())
    assert rounded < 0.99, rounded


# The bf16-q GQA decodes: the chunked and the aligned build round P to bf16,
# as _rpa_kernel_chunked_packed and _rpa_kernel_packed do (they cast p to
# the KV tile's dtype for the P.V dot), at G = 4, the 1B-class and 8B paths'
@pytest.mark.parametrize("pool", ["chunked", "aligned"])
def test_bf16_gqa_decodes_round_p(cuda_device, pool):
    """With bf16 q the chunked and the aligned decode stay within the bf16
    tolerance of the float32 plain version, but match it bitwise on fewer
    than 99% of outputs (a rounded P reads 60-75% where a float32 P reads
    99.8-100%): P is rounded once per position, as their TPU kernels round
    it. A second call is bitwise equal."""
    assert HQ // HKV == 4
    head_dim = D if pool == "chunked" else D_ALIGNED
    q, kv, pt, kvl, _ = _decode_case(cuda_device, torch.bfloat16, aligned=pool == "aligned")
    fn, plain = _decode_fns("rpa_decode" if pool == "chunked" else "rpa_decode_aligned",
                            head_dim)
    kw = _opts("plain", head_dim ** -0.5)
    out = fn(q, kv, 1, pt, kvl, **kw)
    ref = plain(q, kv, 1, pt, kvl, **kw)
    torch.cuda.synchronize()
    assert torch.equal(fn(q, kv, 1, pt, kvl, **kw), out)
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1e-2)
    share = float((out == ref).float().mean())
    assert share < 0.99, share


@pytest.mark.parametrize("pool", ["chunked", "aligned"])
def test_bf16_gqa_extends_round_p(cuda_device, pool):
    """With bf16 q the chunked and the aligned extend (the warpgroup kernel
    without P_SPLIT) stay within the bf16 tolerance of the float32 plain
    version, but match it bitwise on fewer than 99% of outputs, a share that
    P kept in float32 reaches (test_bf16_kernels_keep_p_float32): P is
    rounded to bf16 once per position, as _rpa_kernel_chunked and
    _rpa_kernel's GQA branch cast p to the KV tile's dtype for the P.V dot.
    G = 4, the 1B-class and 8B paths'. A second call is bitwise equal."""
    assert HQ // HKV == 4
    q, kv, pt, kvl, meta = _extend_case(cuda_device, torch.bfloat16, aligned=pool == "aligned")
    head_dim = D if pool == "chunked" else D_ALIGNED
    kw = _opts("plain", head_dim ** -0.5)
    if pool == "chunked":
        kw.update(num_kv_heads=HKV, head_dim=D)
        fn, plain = rpa.ragged_paged_attention_chunked_extend, rpa.extend_attention_plain
    else:
        fn = rpa.ragged_paged_attention_extend
        plain = rpa.ragged_paged_attention_extend_plain
    out = fn(q, kv, 1, pt, kvl, meta, **kw)
    ref = plain(q, kv, 1, pt, kvl, meta, **kw)
    torch.cuda.synchronize()
    assert torch.equal(fn(q, kv, 1, pt, kvl, meta, **kw), out)
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1e-2)
    share = float((out == ref).float().mean())
    assert share < 0.99, share


# (build, pool case options, head_dim, KV dtype): the tensor-core decode of
# every build, split over blocks (the latent pool: one latent head, DLAT wide)
SPLIT_CASES = [("rpa_decode", {}, D, "bfloat16"),
               ("rpa_decode", {}, D, "fp8_e4m3"),
               ("rpa_decode_aligned", {"aligned": True}, D_ALIGNED, "bfloat16"),
               ("rpa_decode_aligned", {"aligned": True}, D_ALIGNED, "fp8_e4m3"),
               ("rpa_decode_merged", {"merged": True}, D, "bfloat16"),
               ("rpa_decode_merged", {"merged": True}, D, "fp8_e4m3"),
               ("rpa_decode_mla", {"latent": True}, DLAT, "bfloat16"),
               ("rpa_decode_mla", {"latent": True}, DLAT, "fp8_e4m3"),
               ("rpa_decode_aligned_256", {"aligned": True, "aligned_dim": 256}, 256,
                "bfloat16"),
               ("rpa_decode_aligned_256", {"aligned": True, "aligned_dim": 256}, 256,
                "fp8_e4m3")]


def _long_decode(dev, extra, kv):
    """16 requests over 2048-4096 positions and one padded row."""
    lens = np.random.default_rng(3).integers(2048, 4097, size=16)
    lens[0], lens[-1] = 4096, 0
    return _case(5, [1] * 16, lens.tolist(), dev, torch.bfloat16,
                 kv_dtype=FP8.get(kv, torch.bfloat16), **extra)


def _decode_fns(build, head_dim):
    """The build's decode wrapper and its plain version."""
    if build == "rpa_decode":
        kw = dict(num_kv_heads=HKV, head_dim=head_dim)
        return (functools.partial(rpa_packed.ragged_paged_attention_chunked_packed, **kw),
                functools.partial(rpa_packed.decode_attention_plain, **kw))
    return (rpa_packed.ragged_paged_attention_packed,
            rpa_packed.ragged_paged_attention_packed_plain)


@pytest.mark.parametrize("opt", ["plain", "softcap", "window"])
@pytest.mark.parametrize("build,extra,head_dim,kv", SPLIT_CASES,
                         ids=[f"{b}-{kv}" for b, _, _, kv in SPLIT_CASES])
def test_merged_decode_splits_long_kv(cuda_device, build, extra, head_dim, kv, opt):
    """The tensor-core decode, first written for the merged build, on every
    build: 16 requests over 2048-4096 positions and one padded row, so the
    build's plan splits each request's positions over several blocks, whose
    float32 partials the combine pass merges; against the plain version,
    bitwise against a second call, and zeros on the padded row. The window
    (1000 positions) crosses split boundaries. On the latent pool (its one
    latent head in the plan) every slot that holds no live position is NaN,
    so none is read."""
    q, kv_t, pt, kvl, _ = _long_decode(cuda_device, extra, kv)
    latent = "latent" in extra
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    n_split, _ = rpa_packed.decode_split_plan(build, 16, 1 if latent else HKV,
                                              pt.shape[1] * PS, sms)
    assert n_split > 1
    kw = _opts(opt, head_dim ** -0.5)
    if opt == "window":
        kw["sliding_window"] = 1000
    if latent:
        kw["v_dim"] = V_DIM
        _poison_dead_slots(kv_t, pt, kvl, 1)
    fn, plain = _decode_fns(build, head_dim)
    k = KERNELS[build]
    before = k.launches
    out = fn(q, kv_t, 1, pt, kvl, **kw)
    again = fn(q, kv_t, 1, pt, kvl, **kw)
    ref = plain(q, kv_t, 1, pt, kvl, **kw)
    torch.cuda.synchronize()
    assert k.launches == before + 2
    assert torch.equal(out, again)
    assert not out[kvl == 0].any()
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("build", ["rpa_decode", "rpa_decode_aligned", "rpa_decode_merged",
                                   "rpa_decode_mla"])
def test_decode_refuses_an_invalid_split_plan(cuda_device, build):
    """The tensor-core decode's entry checks the plan it is given: a
    split_len that is no multiple of the build's step, ranges that do not
    cover the page table, or several splits without a scratch make the
    launch fail, and the wrapper raises; nothing falls back."""
    _, extra, head_dim, kv = next(c for c in SPLIT_CASES if c[0] == build)
    q, kv_t, pt, kvl, _ = _long_decode(cuda_device, extra, kv)
    hkv = 1 if "latent" in extra else HKV
    k = KERNELS[build]
    step = rpa_packed.DECODE_SPLIT[build][0]
    max_kv = pt.shape[1] * PS
    k_ptr, v_ptr, row_stride = rpa_common.kv_planes(kv_t, 1, hkv, head_dim)
    out = torch.empty_like(q)
    scratch = torch.empty(16 * 16 * q.shape[1] * (head_dim + 2), device=cuda_device)
    code = rpa_common.TYPE_CODES
    for n_split, split_len, scr in ((1, max_kv + step // 2, scratch.data_ptr()),
                                    (1, max_kv - max_kv % step - step, scratch.data_ptr()),
                                    (16, -(-max_kv // 16 // step) * step, None)):
        with pytest.raises(RuntimeError, match="cudaError 1$"):
            k.launch(q.data_ptr(), k_ptr, v_ptr, pt.data_ptr(), kvl.data_ptr(), out.data_ptr(),
                     16, q.shape[1], hkv, head_dim, row_stride, pt.shape[1], PS, 1.0, 0.0, 0,
                     code[q.dtype], code[kv_t.dtype], n_split, split_len, scr, None,
                     torch.cuda.current_stream().cuda_stream)


STREAM_POOLS = {  # pool: (case options, kernel, head_dim, the build's type pairs)
    "chunked": ({}, "rpa_decode_stream", D, ["float32", "bfloat16", "fp8_e4m3", "fp8_e5m2"]),
    "aligned": ({"aligned": True}, "rpa_decode_stream_aligned", D_ALIGNED,
                ["float32", "bfloat16", "fp8_e4m3", "fp8_e5m2"]),
    "latent": ({"latent": True}, "rpa_decode_stream_mla", DLAT,
               ["float32", "bfloat16", "fp8_e4m3", "fp8_e5m2"]),
}
STREAM_CASES = [(pool, dtype) for pool, spec in STREAM_POOLS.items() for dtype in spec[3]]
# kv_lens of the stream's batches beside "few" (_decode_case) and "many"
# (_many_case): one request over 16384 positions and three of 1, 9000 and 17
# (the tensor-core stream cuts them across warps and blocks), kv_len-0 rows
# around requests of whole tiles (where warps' shares begin and end), and
# six requests of fewer tiles than the grid has warps
STREAM_BATCHES = {"b1_kv16384": [16384], "b3_1_9000_17": [1, 9000, 17],
                  "zero_rows_at_boundaries": [0, 64, 0, 0, 200, 0, 7, 0, 0, 48, 0, 16, 0],
                  "b6_fewer_tiles_than_warps": [5, 9, 2, 1, 15, 4]}


def _poison_dead_slots(pool, pt, kvl, layer):
    """Sets every slot of the layer that holds no position below a request's
    kv_len to NaN (the dump page 0, the spare page and the ends of the last
    pages): a kernel that read one would put NaN in its output."""
    live = torch.zeros(pool.shape[2] if pool.dim() == 5 else pool.shape[1], dtype=torch.bool)
    for b, n in enumerate(kvl.tolist()):
        pos = torch.arange(n)
        live[pt[b].cpu().long()[pos // PS] * PS + pos % PS] = True
    dead = (~live).nonzero().squeeze(1).to(pool.device)
    if pool.dim() == 5:
        pool[layer, :, dead] = float("nan")
    else:
        pool[layer, dead] = float("nan")


@pytest.mark.parametrize("batch", ["few", "many", *STREAM_BATCHES])
@pytest.mark.parametrize("opt", ["plain", "softcap"])
@pytest.mark.parametrize("pool,dtype", STREAM_CASES, ids=[f"{p}-{t}" for p, t in STREAM_CASES])
def test_stream_kernel_matches_plain_and_repeats(cuda_device, pool, dtype, opt, batch):
    """The streaming decodes against their plain version (the decode's), on
    layer 1 of each pool and for every type pair they are built for, with a
    batch of 6 (fewer rows than blocks), of 200 (several requests per block
    of the CUDA-core kernels, kv_len-0 rows among them) and the
    STREAM_BATCHES, whose requests the tensor-core kernel (bf16 q) cuts
    across warps and blocks; every slot that holds no live position is NaN,
    so none is read; kv_len-0 rows are zeros; a second run on the same
    inputs is bitwise equal (the grid and each warp's share depend on the
    shapes and kv_lens only, the merges run in a fixed order)."""
    extra, name, width, _ = STREAM_POOLS[pool]
    dt = torch.float32 if dtype == "float32" else torch.bfloat16
    kv_dt = FP8.get(dtype, dt)
    if batch in STREAM_BATCHES:
        lens = STREAM_BATCHES[batch]
        q, kv, pt, kvl, _ = _case(11, [1] * len(lens), lens, cuda_device, dt, kv_dtype=kv_dt,
                                  **extra)
    else:
        case = _decode_case if batch == "few" else _many_case
        q, kv, pt, kvl, _ = case(cuda_device, dt, kv_dtype=kv_dt, **extra)
    _poison_dead_slots(kv, pt, kvl, 1)
    kw = _opts(opt, width ** -0.5)
    kw.pop("sliding_window")
    k = KERNELS[name]
    before = k.launches
    if pool == "chunked":
        kw.update(num_kv_heads=HKV, head_dim=D)
        out = rpa_stream.ragged_paged_attention_chunked_stream(q, kv, 1, pt, kvl, **kw)
        again = rpa_stream.ragged_paged_attention_chunked_stream(q, kv, 1, pt, kvl, **kw)
        ref = rpa_packed.decode_attention_plain(q, kv, 1, pt, kvl, **kw)
    else:
        if pool == "latent":
            kw["v_dim"] = V_DIM
        out = rpa_stream.ragged_paged_attention_stream(q, kv, 1, pt, kvl, **kw)
        again = rpa_stream.ragged_paged_attention_stream(q, kv, 1, pt, kvl, **kw)
        ref = rpa_packed.ragged_paged_attention_packed_plain(q, kv, 1, pt, kvl, **kw)
    torch.cuda.synchronize()
    assert k.launches == before + 2
    assert torch.equal(out, again)
    assert not out[kvl == 0].any()
    tol = 1e-4 if dt == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "fp8_e4m3", "fp8_e5m2"])
@pytest.mark.parametrize("batch", ["few", "many", *STREAM_BATCHES])
@pytest.mark.parametrize("opt", ["plain", "softcap"])
def test_mla_decodes_agree_bit_for_bit_whatever_the_batch(cuda_device, opt, batch, kv_dtype):
    """With bf16 q the packed and the streaming latent decode walk each
    request in the same fixed chunks of 256 positions and merge them in the
    same order, so they give the same bits, over bf16 and over fp8 latent
    rows, and a request decoded alone, with a page table of its own pages
    only, gives the bits it gets in the batch: the result does not depend
    on the batch, the split plan or the stream's block shares."""
    bf = torch.bfloat16
    extra = dict(latent=True, kv_dtype=FP8.get(kv_dtype, bf))
    if batch in STREAM_BATCHES:
        lens = STREAM_BATCHES[batch]
        q, kv, pt, kvl, _ = _case(11, [1] * len(lens), lens, cuda_device, bf, **extra)
    else:
        case = _decode_case if batch == "few" else _many_case
        q, kv, pt, kvl, _ = case(cuda_device, bf, **extra)
    kw = dict(_opts(opt, DLAT ** -0.5), v_dim=V_DIM)
    kw.pop("sliding_window")
    packed = rpa_packed.ragged_paged_attention_packed(q, kv, 1, pt, kvl, **kw)
    stream = rpa_stream.ragged_paged_attention_stream(q, kv, 1, pt, kvl, **kw)
    torch.cuda.synchronize()
    assert torch.equal(packed, stream)
    lens = kvl.tolist()
    for b in sorted({0, len(lens) // 2, int(np.argmax(lens))}):
        pages = max(1, -(-lens[b] // PS))
        alone = rpa_packed.ragged_paged_attention_packed(
            q[b:b + 1].contiguous(), kv, 1, pt[b:b + 1, :pages].contiguous(),
            kvl[b:b + 1].contiguous(), **kw)
        torch.cuda.synchronize()
        assert torch.equal(alone[0], packed[b]), (b, lens[b])


def test_stream_builds_run_on_the_tensor_cores(cuda_device):
    """The disassembled libraries of the streaming decodes: every bf16-q
    instantiation (bf16, e4m3 and e5m2 KV) of the chunked and the aligned
    build runs HMMA instructions in rpa_stream_mma_kernel (with and without
    head groups: GROUPS), and the latent
    build's in rpa_stream_mla_mma_kernel; their float32 pair's CUDA-core
    kernel (rpa_stream_kernel, rpa_stream_mla_kernel) none."""
    from semi_pd_tpu_torch.kernels import sass_mma_counts

    for name, mma_fn, core_fn, n_mma in (
            ("rpa_decode_stream", "rpa_stream_mma_kernel", "rpa_stream_kernel", 6),
            ("rpa_decode_stream_aligned", "rpa_stream_mma_kernel", "rpa_stream_kernel", 6),
            ("rpa_decode_stream_mla", "rpa_stream_mla_mma_kernel", "rpa_stream_mla_kernel", 3)):
        KERNELS[name].fn()
        counts = sass_mma_counts(KERNELS[name])
        mma = [n for f, n in counts.items() if mma_fn in f]
        assert len(mma) == n_mma and all(mma), (name, counts)
        core = [n for f, n in counts.items() if core_fn in f]
        assert len(core) == 1 and not any(core), (name, counts)


@pytest.mark.parametrize("name", ["rpa_decode_stream", "rpa_decode_stream_aligned",
                                  "rpa_decode_stream_mla"])
def test_stream_refuses_an_invalid_plan(cuda_device, name):
    """The tensor-core stream's entry checks its plan: no block, or several
    blocks without a scratch, make the launch fail, and the wrapper raises;
    nothing falls back."""
    pool = next(p for p, spec in STREAM_POOLS.items() if spec[1] == name)
    extra, _, head_dim, _ = STREAM_POOLS[pool]
    hkv = 1 if pool == "latent" else HKV
    q, kv_t, pt, kvl, _ = _decode_case(cuda_device, torch.bfloat16, **extra)
    k = KERNELS[name]
    k_ptr, v_ptr, row_stride = rpa_common.kv_planes(kv_t, 1, hkv, head_dim)
    out = torch.empty_like(q)
    code = rpa_common.TYPE_CODES
    for n_blocks in (0, 4):
        with pytest.raises(RuntimeError, match="cudaError 1$"):
            k.launch(q.data_ptr(), k_ptr, v_ptr, pt.data_ptr(), kvl.data_ptr(), out.data_ptr(),
                     q.shape[0], q.shape[1], hkv, head_dim, row_stride, pt.shape[1], PS, 1.0,
                     0.0, 0, code[q.dtype], code[kv_t.dtype], n_blocks, None,
                     torch.cuda.current_stream().cuda_stream)


def test_moe_grouped_mm_matches_plain_loop(cuda_device):
    """moe_ffn on the card in bf16 (torch._grouped_mm) against the same
    function with the plain per-expert loop, at DeepSeek-V2-Lite's expert
    shapes (64 experts, hidden 2048, expert width 1408, top-6), with some
    experts receiving no row."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(0)
    T, d, E, F, K = 37, 2048, 64, 1408, 6
    bf = torch.bfloat16
    x = torch.randn((T, d), generator=g, device=cuda_device).to(bf)
    gate_up = (torch.randn((E, d, 2 * F), generator=g, device=cuda_device) * 0.02).to(bf)
    down = (torch.randn((E, F, d), generator=g, device=cuda_device) * 0.02).to(bf)
    logits = torch.randn((T, E), generator=g, device=cuda_device)
    logits[:, :8] -= 30.0  # experts 0-7 get no row
    w, idx = moe.route_topk(logits, K)
    got = moe.moe_ffn(x, gate_up, down, w, idx)
    want = moe.moe_ffn(x, gate_up, down, w, idx, matmul=moe.grouped_matmul_plain)
    torch.cuda.synchronize()
    assert got.dtype == bf and got.shape == (T, d) and torch.isfinite(got).all()
    err = float((got.float() - want.float()).abs().max() / want.float().abs().max())
    assert err < 2e-2, err


@pytest.mark.parametrize("grouped", [False, True], ids=["greedy", "grouped"])
def test_moe_routes_and_sums_without_a_host_sync(cuda_device, grouped):
    """route_topk (DeepSeek-V2's greedy softmax, and V3's sigmoid grouped
    selection with its score bias) and moe_ffn in bf16 at a decode batch
    make no host sync: the experts' row counts stay on the card."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(2)
    T, d, E, F, K = 64, 256, 64, 128, 6
    bf = torch.bfloat16
    x = torch.randn((T, d), generator=g, device=cuda_device).to(bf)
    gate_up = (torch.randn((E, d, 2 * F), generator=g, device=cuda_device) * 0.05).to(bf)
    down = (torch.randn((E, F, d), generator=g, device=cuda_device) * 0.05).to(bf)
    logits = torch.randn((T, E), generator=g, device=cuda_device)
    kw = (dict(scoring="sigmoid", n_group=8, topk_group=4,
               e_score_bias=torch.randn(E, generator=g, device=cuda_device))
          if grouped else {})
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        w, idx = moe.route_topk(logits, K, **kw)
        out = moe.moe_ffn(x, gate_up, down, w, idx)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = moe.moe_ffn(x, gate_up, down, w, idx, matmul=moe.grouped_matmul_plain)
    err = float((out.float() - want.float()).abs().max() / want.float().abs().max())
    assert err < 2e-2, err


def test_moe_ffn_is_deterministic_on_the_card(cuda_device):
    """The same bf16 inputs give bitwise the same moe_ffn output every call
    (each token's K rows are summed in a fixed order, not scatter-added
    with atomics), at DeepSeek-V2-Lite's expert shapes and a prefill
    chunk's 2048 tokens."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(1)
    T, d, E, F, K = 2048, 2048, 64, 1408, 6
    bf = torch.bfloat16
    x = torch.randn((T, d), generator=g, device=cuda_device).to(bf)
    gate_up = (torch.randn((E, d, 2 * F), generator=g, device=cuda_device) * 0.02).to(bf)
    down = (torch.randn((E, F, d), generator=g, device=cuda_device) * 0.02).to(bf)
    w, idx = moe.route_topk(torch.randn((T, E), generator=g, device=cuda_device), K)
    first = moe.moe_ffn(x, gate_up, down, w, idx)
    for _ in range(3):
        assert torch.equal(moe.moe_ffn(x, gate_up, down, w, idx), first)


def _engines_agree(cuda_device, cfg, pool_kernels, decode_stream=False):
    """The Engine with no device argument runs on the card through the
    given pool's two kernels (and no other) and gives the greedy tokens of
    the same Engine on the CPU holding the same parameters (CUDA and CPU
    generators draw different random weights)."""
    serve = dict(random_weights=True, page_size=PS, max_total_tokens=2048,
                 chunked_prefill_size=64, enable_semi_pd=True, decode_stream=decode_stream)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, size=n).tolist() for n in (20, 100, 37)]
    sp = SamplingParams(max_new_tokens=6, temperature=0.0, ignore_eos=True)
    gpu = Engine(ServerArgs(**serve), ModelConfig(**cfg))
    assert gpu.runner.device.type == "cuda"
    cpu = Engine(ServerArgs(device="cpu", **serve), ModelConfig(**cfg), device="cpu")
    cpu.runner.model.load_jax_params(gpu.runner.model.params_tree())
    for k in KERNELS.values():
        k.launches = 0
    got = gpu.generate(input_ids=prompts, sampling_params=sp)
    assert {n for n, k in KERNELS.items() if k.launches} == set(pool_kernels)
    want = cpu.generate(input_ids=prompts, sampling_params=sp)
    assert [o["output_ids"] for o in got] == [o["output_ids"] for o in want]
    assert gpu.flush_cache() and cpu.flush_cache()


def _llama_cfg(head_dim, num_kv_heads=HKV):
    return dict(architecture="LlamaForCausalLM", vocab_size=512, hidden_size=256,
                intermediate_size=512, num_hidden_layers=2, num_attention_heads=HQ,
                num_key_value_heads=num_kv_heads, head_dim=head_dim, context_length=512,
                dtype="float32")


def test_engine_on_default_cuda_device_matches_cpu(cuda_device):
    """Hkv 8 at head_dim 64: the chunked pool (Hkv 2 is on the 5D pool)."""
    _engines_agree(cuda_device, _llama_cfg(D, num_kv_heads=8), ["rpa_decode", "rpa_extend"])


def test_engine_aligned_pool_on_cuda_matches_cpu(cuda_device):
    _engines_agree(cuda_device, _llama_cfg(D_ALIGNED),
                   ["rpa_decode_aligned", "rpa_extend_aligned"])


def test_engine_merged_pool_on_cuda_matches_cpu(cuda_device):
    """Hkv 2 at head_dim 64: the 5D pool through the merged kernels, with
    the streaming decode asked for too (the JAX routing keeps the merged
    decode there)."""
    _engines_agree(cuda_device, _llama_cfg(D), ["rpa_decode_merged", "rpa_extend_merged"],
                   decode_stream=True)


@pytest.mark.parametrize("head_dim,num_kv_heads,kernels", [
    (D, 8, ["rpa_decode_stream", "rpa_extend"]),
    (D_ALIGNED, HKV, ["rpa_decode_stream_aligned", "rpa_extend_aligned"]),
], ids=["chunked", "aligned"])
def test_engine_decode_stream_on_cuda_matches_cpu(cuda_device, head_dim, num_kv_heads,
                                                  kernels):
    _engines_agree(cuda_device, _llama_cfg(head_dim, num_kv_heads), kernels,
                   decode_stream=True)


@pytest.mark.parametrize("decode_stream", [False, True], ids=["packed", "stream"])
def test_engine_deepseek_latent_pool_on_cuda_matches_cpu(cuda_device, decode_stream):
    """A small DeepSeek-V2 (a dense layer, then an MoE layer with a shared
    expert; the kernels' latent width 512 + 64, 16 heads) in float32, with
    the packed and with the streaming decode."""
    cfg = _deepseek_cfg()
    dec = "rpa_decode_stream_mla" if decode_stream else "rpa_decode_mla"
    _engines_agree(cuda_device, cfg, [dec, "rpa_extend_mla"], decode_stream=decode_stream)


def _last_logits(eng, ids):
    """The engine's model logits after ``ids`` (float32 [vocab]), from one
    prefill of them through its runner's model and attention routing."""
    from semi_pd_tpu_torch.runtime.batch import build_extend_batch
    from semi_pd_tpu_torch.runtime.req import Req

    runner, sched = eng.runner, eng.scheduler
    r = Req(rid="tf", input_ids=list(ids), sampling_params=SamplingParams(temperature=0.0))
    r.req_slot = runner.req_pool.alloc()
    pages = runner.page_allocator.alloc(-(-len(ids) // PS))
    r.pages = pages.tolist()
    runner.req_pool.write(r.req_slot, 0, pages)
    hb = build_extend_batch([(r, len(ids))], runner.req_pool.page_table, PS, sched.t_buckets,
                            sched.b_buckets, sched.p_buckets)
    try:
        with torch.inference_mode():
            logits = runner.model(hb.to_device(runner.device), runner.kv_cache.buffer,
                                  attention=runner.attention)
        return logits[0].float().cpu()
    finally:
        runner.page_allocator.free(pages)
        runner.req_pool.free(r.req_slot)


@pytest.mark.parametrize("pool,kernels", [
    ("chunked", ["rpa_decode", "rpa_extend"]),
    ("latent", ["rpa_decode_mla", "rpa_extend_mla"]),
])
@pytest.mark.parametrize("kv", ["fp8_e4m3", "fp8_e5m2"])
def test_engine_fp8_pools_on_cuda_match_cpu(cuda_device, pool, kernels, kv):
    """fp8 KV on the chunked pool (Hkv 8, head_dim 64) and fp8 latent rows
    (the kernels' 512 + 64) served on the card through the pool's two
    kernels, against the same Engine on the CPU holding the same bf16
    parameters (the card's kernels take fp8 under bf16 q). Unit final-norm
    weights spread the logits; each request's greedy tokens must equal the
    CPU's up to a first difference, which may only fall at a near tie: the
    CPU's logit for the card's token within 2% of its logit range of its
    own argmax (bf16 products summed in another order on two devices may
    move a K or V value to the next fp8 step)."""
    cfg = dict((_llama_cfg(D, num_kv_heads=8) if pool == "chunked" else _deepseek_cfg()),
               dtype="bfloat16")
    serve = dict(random_weights=True, page_size=PS, max_total_tokens=2048,
                 chunked_prefill_size=64, enable_semi_pd=True, kv_cache_dtype=kv)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, size=n).tolist() for n in (20, 100, 37, 64)]
    sp = SamplingParams(max_new_tokens=6, temperature=0.0, ignore_eos=True)
    gpu = Engine(ServerArgs(**serve), ModelConfig(**cfg))
    assert gpu.runner.kv_cache.buffer.dtype == FP8[kv]
    gpu.runner.model.leaf("final_norm").fill_(1.0)
    cpu = Engine(ServerArgs(device="cpu", **serve), ModelConfig(**cfg), device="cpu")
    cpu.runner.model.load_jax_params(gpu.runner.model.params_tree())
    for k in KERNELS.values():
        k.launches = 0
    got = [o["output_ids"] for o in gpu.generate(input_ids=prompts, sampling_params=sp)]
    assert {n for n, k in KERNELS.items() if k.launches} == set(kernels)
    want = [o["output_ids"] for o in cpu.generate(input_ids=prompts, sampling_params=sp)]
    assert gpu.flush_cache() and cpu.flush_cache()
    for prompt, g, w in zip(prompts, got, want):
        j = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if j is None:
            continue
        logits = _last_logits(cpu, prompt + w[:j])
        assert int(logits.argmax()) == w[j]
        gap = float(logits[w[j]] - logits[g[j]])
        assert gap <= 0.02 * float(logits.max() - logits.min()), (j, gap)


# ---------------------------------------------------------------- decode graphs
def _deepseek_cfg(dtype="float32"):
    return dict(architecture="DeepseekV2ForCausalLM", vocab_size=512, hidden_size=256,
                intermediate_size=512, num_hidden_layers=2, num_attention_heads=HQ_MLA,
                num_key_value_heads=HQ_MLA, head_dim=192, context_length=512,
                use_mla=True, kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
                v_head_dim=128, num_experts=8, num_experts_per_tok=2,
                moe_intermediate_size=128, num_shared_experts=1, first_k_dense_replace=1,
                dtype=dtype)


def _minicpm3_cfg(dtype="float32"):
    """A small MiniCPM3 at the kernels' latent width (kv_lora 256 + rope 32,
    V 256) with 40 heads, its scalings and a longrope table."""
    return dict(architecture="MiniCPM3ForCausalLM", vocab_size=512, hidden_size=256,
                intermediate_size=512, num_hidden_layers=2, num_attention_heads=40,
                num_key_value_heads=40, head_dim=96, context_length=512,
                rope_scaling={"type": "longrope", "original_max_position_embeddings": 256,
                              "short_factor": [1.0 + 0.1 * i for i in range(16)],
                              "long_factor": [2.0 + 0.5 * i for i in range(16)]},
                use_mla=True, q_lora_rank=96, kv_lora_rank=256, qk_nope_head_dim=64,
                qk_rope_head_dim=32, v_head_dim=64, scale_emb=12.0, scale_depth=1.4,
                dim_model_base=64.0, dtype=dtype)


# the decode paths at a tiny depth in bf16: (model config, ServerArgs
# fields, the decode kernel)
GRAPH_PATHS = {
    "chunked": (dict(_llama_cfg(D, num_kv_heads=8), dtype="bfloat16"), {}, "rpa_decode"),
    "aligned_fp8": (dict(_llama_cfg(D_ALIGNED), dtype="bfloat16"),
                    {"kv_cache_dtype": "fp8_e4m3"}, "rpa_decode_aligned"),
    "latent_moe": (_deepseek_cfg("bfloat16"), {}, "rpa_decode_mla"),
    "merged": (dict(_llama_cfg(D), dtype="bfloat16"), {}, "rpa_decode_merged"),
    "stream_chunked": (dict(_llama_cfg(D, num_kv_heads=8), dtype="bfloat16"),
                       {"decode_stream": True}, "rpa_decode_stream"),
    "stream_aligned": (dict(_llama_cfg(D_ALIGNED), dtype="bfloat16"),
                       {"decode_stream": True, "kv_cache_dtype": "fp8_e4m3"},
                       "rpa_decode_stream_aligned"),
    "stream_latent": (_deepseek_cfg("bfloat16"), {"decode_stream": True},
                      "rpa_decode_stream_mla"),
    # fp8 KV on the chunked pool, fp8 latent rows
    "chunked_fp8": (dict(_llama_cfg(D, num_kv_heads=8), dtype="bfloat16"),
                    {"kv_cache_dtype": "fp8_e4m3"}, "rpa_decode"),
    "latent_fp8": (_deepseek_cfg("bfloat16"), {"kv_cache_dtype": "fp8_e4m3"},
                   "rpa_decode_mla"),
    # MiniCPM3's 288-wide latent rows: the _288 builds
    "latent288": (_minicpm3_cfg("bfloat16"), {}, "rpa_decode_mla_288"),
    "latent288_fp8": (_minicpm3_cfg("bfloat16"), {"kv_cache_dtype": "fp8_e4m3"},
                      "rpa_decode_mla_288"),
    "stream_latent288": (_minicpm3_cfg("bfloat16"), {"decode_stream": True},
                         "rpa_decode_stream_mla_288"),
}


def _graph_engine(dev, path, seed=0):
    """An Engine on the card on one decode path, its pool filled with
    random values."""
    cfg, extra, _ = GRAPH_PATHS[path]
    eng = Engine(ServerArgs(random_weights=True, page_size=PS, max_total_tokens=4096,
                            chunked_prefill_size=64, **extra), ModelConfig(**cfg))
    assert eng.runner.graphs is not None
    _fill_pool(eng, dev, seed)
    return eng


def _fill_pool(eng, dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    buf = eng.runner.kv_cache.buffer
    buf.copy_(torch.randn(buf.shape, generator=g, device=dev).to(buf.dtype))


def _graph_batch(eng, lens, seed):
    """The packed decode step of requests with the given KV lengths, pages
    from the allocator, random last tokens."""
    from semi_pd_tpu_torch.runtime.batch import build_decode_batch
    from semi_pd_tpu_torch.runtime.req import Req

    runner, sched = eng.runner, eng.scheduler
    rng = np.random.default_rng(seed)
    reqs = []
    for i, n in enumerate(lens):
        r = Req(rid=f"g{seed}-{i}", input_ids=[1] * int(n),
                sampling_params=SamplingParams(temperature=0.0))
        r.req_slot = runner.req_pool.alloc()
        pages = runner.page_allocator.alloc(-(-(int(n) + 1) // PS))
        r.pages = pages.tolist()
        runner.req_pool.write(r.req_slot, 0, pages)
        r.prefilled_len = r.prompt_len
        r.output_ids.append(int(rng.integers(0, 512)))
        reqs.append(r)
    return build_decode_batch(reqs, runner.req_pool.page_table, PS, sched.b_buckets,
                              sched.p_buckets).pack()


def _eager_step(runner, *args, **kw):
    graphs, runner.graphs = runner.graphs, None
    try:
        return runner.step_packed_raw(*args, **kw)
    finally:
        runner.graphs = graphs


@pytest.mark.parametrize("path", sorted(GRAPH_PATHS))
def test_decode_graph_replays_the_eager_step_bitwise(cuda_device, path):
    """On each decode path a replay gives the eager step's tokens and
    log-probs bitwise, then again on another batch of the same key (other
    lengths and pages, a refilled pool, input ids chained from the first
    step's tokens); the capture counts no launch, each replay the path's
    L decode launches; neither the eager step nor a replay syncs the
    host."""
    eng = _graph_engine(cuda_device, path)
    runner = eng.runner
    dec = GRAPH_PATHS[path][2]
    L = runner.model_config.num_hidden_layers
    for k in KERNELS.values():
        k.launches = 0
    step1 = _graph_batch(eng, [33, 260, 9, 77, 1, 140], seed=1)
    want = _eager_step(runner, *step1, is_decode=True)
    got = runner.step_packed_raw(*step1, is_decode=True)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.isfinite(got[1]).all()
    (g,) = runner.graphs.graphs.values()
    assert g.tally == {dec: L} and KERNELS[dec].launches == 2 * L
    _fill_pool(eng, cuda_device, seed=2)
    step2 = _graph_batch(eng, [300, 17, 64, 2, 199], seed=2)
    assert step2[2] == step1[2]  # the same key
    kw = dict(chained=True, prev_tokens=want[0], is_decode=True)
    want2 = _eager_step(runner, *step2, **kw)
    got2 = runner.step_packed_raw(*step2, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got2[0], want2[0]) and torch.equal(got2[1], want2[1])
    assert not torch.equal(got2[1], got[1])
    assert runner.graphs.stats["captures"] == 1 and KERNELS[dec].launches == 4 * L
    assert runner.graphs.pool_bytes() > 0
    assert {n for n, k in KERNELS.items() if k.launches} == {dec}
    torch.cuda.set_sync_debug_mode("error")
    try:
        _eager_step(runner, *step2, is_decode=True)
        runner.step_packed_raw(*step2, is_decode=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_sampling_replays_advance_the_generator(cuda_device):
    """With every row sampling, two replays of one step draw different
    tokens (the registered generator advances), and each equals the eager
    step run from the same generator state."""
    eng = _graph_engine(cuda_device, "chunked")
    runner = eng.runner
    ints, floats, shapes = _graph_batch(eng, [33, 260, 9, 77, 1, 140], seed=3)
    floats = floats.copy()
    floats[: shapes[1]] = 1.0  # temperature
    got, want = [], []
    for _ in range(2):
        state = runner.generator.get_state()
        want.append(_eager_step(runner, ints, floats, shapes, is_decode=True))
        runner.generator.set_state(state)
        got.append(runner.step_packed_raw(ints, floats, shapes, is_decode=True))
    torch.cuda.synchronize()
    for (gt, gl), (wt, wl) in zip(got, want):
        assert torch.equal(gt, wt) and torch.equal(gl, wl)
    assert not torch.equal(got[0][0], got[1][0])
    assert [k[3] for k in runner.graphs.graphs] == [False]


def test_engine_serves_the_same_tokens_on_graphs_and_eagerly(cuda_device):
    """The Engine on graphs (the default) and with decode_graphs=False give
    the same greedy tokens, with every decode step replayed."""
    cfg = dict(_llama_cfg(D, num_kv_heads=8), dtype="bfloat16")
    serve = dict(random_weights=True, page_size=PS, max_total_tokens=2048,
                 chunked_prefill_size=64, enable_semi_pd=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, size=n).tolist() for n in (20, 100, 37)]
    sp = SamplingParams(max_new_tokens=12, temperature=0.0, ignore_eos=True)
    outs = []
    for graphs in (True, False):
        eng = Engine(ServerArgs(**serve), ModelConfig(**cfg), decode_graphs=graphs)
        outs.append([o["output_ids"] for o in eng.generate(input_ids=prompts,
                                                            sampling_params=sp)])
        if graphs:
            assert eng.runner.graphs.stats["replays"] == eng.runner.step_counts["decode"] > 0
        else:
            assert eng.runner.graphs is None
    assert outs[0] == outs[1]


# ------------------------------------------------------------ step variants
# a decode step's grammar mask, logit bias, penalties and top-k (the
# scheduler's step_host / step_topk_host), each replayed under its own key
STEP_VARIANTS = {
    "bool": dict(mask="bool"), "bias": dict(mask="bias"), "penalties": dict(penalties=True),
    "top_k": dict(top_k=5), "all": dict(mask="bias", penalties=True, top_k=3),
    "sampled_all": dict(mask="bool", penalties=True, top_k=2, sampled=True),
}


def _variant_step(eng, lens, seed, mask=None, penalties=False, top_k=0, sampled=False):
    """A decode batch of requests with the given KV lengths (three
    generated tokens each, penalized), and a step function running it with
    the variant's host arrays: ``step()`` -> the runner's outputs."""
    from semi_pd_tpu_torch.runtime.batch import build_decode_batch
    from semi_pd_tpu_torch.runtime.req import Req

    runner, sched = eng.runner, eng.scheduler
    V = runner.model_config.vocab_size
    rng = np.random.default_rng(seed)
    reqs = []
    for i, n in enumerate(lens):
        r = Req(rid=f"v{seed}-{i}", input_ids=rng.integers(0, V, size=int(n)).tolist(),
                sampling_params=SamplingParams(temperature=1.0 if sampled else 0.0,
                                               repetition_penalty=1.3, frequency_penalty=0.2))
        r.req_slot = runner.req_pool.alloc()
        pages = runner.page_allocator.alloc(-(-(int(n) + 1) // PS))
        r.pages = pages.tolist()
        runner.req_pool.write(r.req_slot, 0, pages)
        r.prefilled_len = r.prompt_len - 2
        r.output_ids = rng.integers(0, V, size=3).tolist()
        reqs.append(r)
    hb = build_decode_batch(reqs, runner.req_pool.page_table, PS, sched.b_buckets,
                            sched.p_buckets)
    vm = None
    if mask == "bool":
        vm = rng.random((hb.B, V)) < 0.2
    elif mask == "bias":
        vm = rng.uniform(-4, 4, (hb.B, V)).astype(np.float32)
        vm[rng.random((hb.B, V)) < 0.3] = -np.inf
    pen = sched._penalty_arrays(reqs, hb.B) if penalties else None
    if top_k:
        return hb, lambda: runner.step_topk_host(hb, top_k, vm, pen)
    return hb, lambda: runner.step_host(hb, vm, pen)


def _eager_variant(runner, step):
    graphs, runner.graphs = runner.graphs, None
    try:
        return step()
    finally:
        runner.graphs = graphs


@pytest.mark.parametrize("variant", sorted(STEP_VARIANTS))
def test_step_variant_replays_the_eager_step_bitwise(cuda_device, variant):
    """On the 8B's path (the 5D pool at head_dim 128, fp8_e4m3 KV) a decode
    step with a grammar mask, a logit bias, penalties, a top-k, or several
    at once, replayed from its own key's graph, gives the eager step's
    outputs bitwise (sampled rows from the same generator state), on two
    batches of one key; the capture counts nothing and its replay the
    path's L decode launches; the key is the plain one with the variant
    after it; neither the eager step nor a replay syncs the host."""
    from semi_pd_tpu_torch.runtime.cuda_graph_runner import StepVariant, decode_key

    eng = _graph_engine(cuda_device, "aligned_fp8")
    runner = eng.runner
    dec = GRAPH_PATHS["aligned_fp8"][2]
    L = runner.model_config.num_hidden_layers
    kw = STEP_VARIANTS[variant]
    for k in KERNELS.values():
        k.launches = 0
    for seed, lens in ((1, [33, 260, 9, 77, 3, 140]), (2, [300, 17, 64, 4, 199])):
        hb, step = _variant_step(eng, lens, seed, **kw)
        state = runner.generator.get_state()
        want = _eager_variant(runner, step)
        runner.generator.set_state(state)
        got = step()
        torch.cuda.synchronize()
        assert len(got) == len(want) == (4 if kw.get("top_k") else 2)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert torch.isfinite(got[1]).all()
    key = decode_key(hb.pack()[2], not kw.get("sampled"),
                     StepVariant(kw.get("mask"), kw.get("penalties", False), kw.get("top_k", 0)))
    assert list(runner.graphs.graphs) == [key] and len(key) == 5
    (g,) = runner.graphs.graphs.values()
    assert g.tally == {dec: L} and KERNELS[dec].launches == 4 * L
    assert runner.graphs.stats["captures"] == 1
    torch.cuda.set_sync_debug_mode("error")
    try:
        _eager_variant(runner, step)
        step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_plain_key_unchanged_beside_the_variants(cuda_device):
    """The plain decode step keeps its four-field key, its graph and its
    launch tally when variant keys are captured beside it, and still
    replays the eager step bitwise."""
    from semi_pd_tpu_torch.runtime.cuda_graph_runner import decode_key

    eng = _graph_engine(cuda_device, "aligned_fp8")
    runner = eng.runner
    dec = GRAPH_PATHS["aligned_fp8"][2]
    L = runner.model_config.num_hidden_layers
    plain = _graph_batch(eng, [33, 260, 9, 77, 1, 140], seed=1)
    first = runner.step_packed_raw(*plain, is_decode=True)
    key = decode_key(plain[2], True)
    g = runner.graphs.graphs[key]
    tally, handle = dict(g.tally), g.handle
    for kw in STEP_VARIANTS.values():
        hb, step = _variant_step(eng, [40, 7, 90], 3, **kw)
        step()
        for r in hb.reqs:  # the slots and pages go back for the next variant
            runner.page_allocator.free(np.asarray(r.pages, np.int32))
            runner.req_pool.free(r.req_slot)
    assert len(runner.graphs.graphs) == 1 + len(STEP_VARIANTS)
    assert runner.graphs.graphs[key] is g and g.handle is handle and g.tally == tally == {dec: L}
    want = _eager_step(runner, *plain, is_decode=True)
    got = runner.step_packed_raw(*plain, is_decode=True)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[0], first[0])


def test_engine_serves_constrained_requests_on_graphs_as_eagerly(cuda_device):
    """A batch of a regex, a penalized, a logit-bias and a top-k request
    beside a plain one on the card: every decode step replayed (masked keys
    among the graphs), and the tokens, log-probs and top-k of the same
    Engine with decode_graphs=False; the regex output matches its
    grammar."""
    import re

    class Tok:  # printable ASCII, then EOS
        vocab_size = 512
        eos_token_id = 95
        all_special_ids = [95]

        def __len__(self):
            return 512

        def decode(self, ids, **kw):
            return "".join(chr(32 + i) for i in ids if i < 95)

    cfg = dict(_llama_cfg(D_ALIGNED), dtype="bfloat16")
    regex = r"(ab|cd)=[0-9]{2,4};"
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, size=n).tolist() for n in (20, 100, 37, 64, 9)]
    base = dict(max_new_tokens=12, temperature=0.0)
    sps = [dict(base, regex=regex), dict(base, repetition_penalty=1.3, ignore_eos=True),
           dict(base, custom_logit_processor="logit_bias", ignore_eos=True,
                custom_params={"logit_bias": {"33": 3.0}}),
           dict(base, ignore_eos=True), dict(base, ignore_eos=True)]
    topk = [0, 0, 0, 4, 0]
    outs = []
    for graphs in (True, False):
        eng = Engine(ServerArgs(random_weights=True, page_size=PS, max_total_tokens=4096,
                                chunked_prefill_size=64, kv_cache_dtype="fp8_e4m3",
                                disable_outlines_disk_cache=True),
                     ModelConfig(**cfg), tokenizer=Tok(), decode_graphs=graphs)
        reqs = [eng.make_request(p, SamplingParams(**sp), return_logprob=True,
                                 top_logprobs_num=k) for p, sp, k in zip(prompts, sps, topk)]
        for r in reqs:
            eng.scheduler.add_request(r)
        eng._run_until_done(reqs)
        outs.append([eng._to_output(r) for r in reqs])
        if graphs:
            assert eng.runner.graphs.stats["replays"] == eng.runner.step_counts["decode"] > 0
            assert any(len(k) == 5 for k in eng.runner.graphs.graphs)
        assert eng.flush_cache()
    a, b = outs
    assert [o["output_ids"] for o in a] == [o["output_ids"] for o in b]
    for x, y in zip(a, b):
        assert x["meta_info"]["output_logprobs"] == y["meta_info"]["output_logprobs"]
        assert x["meta_info"]["output_top_logprobs"] == y["meta_info"]["output_top_logprobs"]
    if a[0]["meta_info"]["finish_reason"] == "stop_token":
        assert re.fullmatch(regex, Tok().decode(a[0]["output_ids"]))


# ------------------------------------------------------------ speculation trees
SPEC_BUILDS = {  # build: (pool layout, Hq, Hkv, head_dim)
    "rpa_extend": ("chunked", 16, 8, D),
    "rpa_extend_aligned": ("aligned", 8, 2, D_ALIGNED),
    "rpa_extend_merged": ("aligned", 32, 8, D),  # the 1B-class draft pool's geometry
    "rpa_extend_mla": ("latent", HQ_MLA, 1, DLAT),  # DeepSeek-V2's latent row, NextN's
    # Gemma-2-9B's heads at head_dim 256 (EAGLE's verify and tree draft steps)
    "rpa_extend_aligned_256": ("aligned", 16, 8, 256),
    # MiniCPM3-4B's 40 heads over the 288 latent row (NextN's)
    "rpa_extend_mla_288": ("latent", 40, 1, 288),
}
SPEC_TYPES = {"rpa_extend": ["float32", "bfloat16"],
              "rpa_extend_aligned": ["float32", "bfloat16", "fp8_e4m3"],
              "rpa_extend_merged": ["float32", "bfloat16", "fp8_e4m3"],
              "rpa_extend_mla": ["float32", "bfloat16", "fp8_e4m3"],
              "rpa_extend_aligned_256": ["float32", "bfloat16", "fp8_e4m3", "fp8_e5m2"],
              "rpa_extend_mla_288": ["float32", "bfloat16", "fp8_e4m3", "fp8_e5m2"]}
# V's width on each latent build
SPEC_V = {DLAT: V_DIM, 288: 256}
SPEC_CASES = [(b, t) for b, ts in SPEC_TYPES.items() for t in ts]


def _tree_case(dev, build, dtype, draft_level=None, prefix=(40, 17, 3, 130)):
    """A speculation tree's attention on the card: requests with ``prefix``
    committed positions, each followed by the window of the (4, 2, 1, 1)
    tree's 29 nodes, on shuffled pages, every slot no live position holds
    NaN. Without ``draft_level``: the verify (29 rows per request); with
    it: that level's draft step (B * n rows of q_len 1 over the page table
    tiled n times, kv_len = the node's slot + 1)."""
    from semi_pd_tpu_torch.speculative.eagle import _decode_meta
    from semi_pd_tpu_torch.speculative.tree import default_tree_template

    tree = default_tree_template(4, 4)
    layout, hq, hkv, d = SPEC_BUILDS[build]
    N, B = tree.num_nodes, len(prefix)
    rng = np.random.default_rng(21)
    lens = np.asarray(prefix) + N
    n_pages = [-(-int(k) // PS) for k in lens]
    total = sum(n_pages) + 1
    perm = rng.permutation(np.arange(1, total))
    pt = np.zeros((B, max(n_pages)), np.int32)
    live = np.zeros(total * PS, bool)
    used = 0
    for b, n in enumerate(n_pages):
        pt[b, :n] = perm[used:used + n]
        used += n
        pos = np.arange(lens[b])
        live[pt[b, pos // PS] * PS + pos % PS] = True
    shape = {"chunked": (L, total * PS, 2 * hkv * d // 128, 128),
             "aligned": (L, 2, total * PS, hkv, d), "latent": (L, 1, total * PS, 1, d)}[layout]
    pool = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    if layout == "chunked":
        pool[:, torch.from_numpy(~live)] = float("nan")
    else:
        pool[:, :, torch.from_numpy(~live)] = float("nan")
    win = np.asarray(prefix, np.int32)
    if draft_level is None:
        T = B * N
        m = build_attn_meta(np.full(B, N), lens, T)
        meta = AttnMeta(*[_unaligned(a.numpy(), dev) for a in m])
    else:
        level = tree.level_nodes[draft_level]
        mpos = np.concatenate([win + j for j in level]).astype(np.int32)
        T, lens = len(mpos), mpos + 1
        meta = _decode_meta(torch.from_numpy(mpos).to(dev))
        pt, win = np.tile(pt, (len(level), 1)), np.tile(win, len(level))
    q = torch.from_numpy(rng.normal(size=(T, hq, d)).astype(np.float32))
    dt = torch.float32 if dtype == "float32" else torch.bfloat16
    return dict(q=q.to(dev, dt), pool=pool.to(dev, FP8.get(dtype, dt)),
                pt=_unaligned(pt, dev), kvl=_unaligned(lens.astype(np.int32), dev), meta=meta,
                win_base=_unaligned(win, dev), anc=tuple(int(a) for a in tree.anc_bits),
                tol=1e-4 if dt == torch.float32 else 1e-2)


def _tree_fns(build, c):
    layout, _, hkv, d = SPEC_BUILDS[build]
    args = (c["q"], c["pool"], 1, c["pt"], c["kvl"], c["meta"])
    kw = dict(page_size=PS, scale=d ** -0.5, spec_anc=c["anc"], win_base=c["win_base"])
    if layout == "latent":
        kw["v_dim"] = SPEC_V[d]
    if layout == "chunked":
        return (lambda **o: rpa.ragged_paged_attention_chunked_extend(
                    *args, num_kv_heads=hkv, head_dim=d, **{**kw, **o}),
                lambda **o: rpa.extend_attention_plain(
                    *args, num_kv_heads=hkv, head_dim=d, **{**kw, **o}))
    return (lambda **o: rpa.ragged_paged_attention_extend(*args, **{**kw, **o}),
            lambda **o: rpa.ragged_paged_attention_extend_plain(*args, **{**kw, **o}))


@pytest.mark.parametrize("draft_level", [None, 1, 3], ids=["verify", "draft1", "draft3"])
@pytest.mark.parametrize("build,dtype", SPEC_CASES, ids=[f"{b}-{t}" for b, t in SPEC_CASES])
def test_tree_masked_extend_matches_plain(cuda_device, build, dtype, draft_level):
    """The six extends (the four GQA builds and the two MLA ones, NextN's)
    with a speculation tree's masks against their plain version: the verify and
    two draft steps (decode-shaped, taken by the extend), on layer 1, every
    dead slot NaN; the tree changes the answer (a chain over the same
    window gives another), and the kernel with the chain matches its plain
    version too."""
    c = _tree_case(cuda_device, build, dtype, draft_level)
    kern, plain = _tree_fns(build, c)
    k = KERNELS[build]
    before = k.launches
    out, ref = kern(), plain()
    torch.cuda.synchronize()
    assert k.launches == before + 1
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), rtol=c["tol"], atol=c["tol"])
    chain = tuple((1 << (j + 1)) - 1 for j in range(len(c["anc"])))
    other = kern(spec_anc=chain)
    torch.testing.assert_close(other.float(), plain(spec_anc=chain).float(), rtol=c["tol"],
                               atol=c["tol"])
    assert (other.float() - out.float()).abs().max() > 1e-2


@pytest.mark.parametrize("build", sorted(SPEC_BUILDS))
def test_tree_masked_extend_repeats_bitwise(cuda_device, build):
    c = _tree_case(cuda_device, build, "bfloat16")
    kern, _ = _tree_fns(build, c)
    assert torch.equal(kern(), kern())


TREE_WINDOW_TYPES = ["float32", "bfloat16", "fp8_e4m3", "fp8_e5m2"]


@pytest.mark.parametrize("dtype", TREE_WINDOW_TYPES)
def test_tree_verify_at_256_with_softcap_and_a_window_inside_the_tree(cuda_device, dtype):
    """rpa_extend_aligned_256's TREE instantiations as Gemma-2's windowed
    layers run them in EAGLE's tree verify: softcap 1.0 and a window of 24,
    shorter than the 29-node tree, so that node i of a request whose tree
    starts at b sees positions above b + i - 24 (its slot-order position,
    as _rpa_kernel tests it) and the deepest nodes lose their root; every
    type pair, every dead slot NaN, against the plain version; a second run
    bitwise equal; the window and the cap each change the answer."""
    c = _tree_case(cuda_device, "rpa_extend_aligned_256", dtype)
    kern, plain = _tree_fns("rpa_extend_aligned_256", c)
    k = KERNELS["rpa_extend_aligned_256"]
    o = dict(logit_cap=1.0, sliding_window=24)
    before = k.launches
    out, again, ref = kern(**o), kern(**o), plain(**o)
    torch.cuda.synchronize()
    assert k.launches == before + 2
    assert torch.isfinite(out).all() and torch.equal(out, again)
    torch.testing.assert_close(out.float(), ref.float(), rtol=c["tol"], atol=c["tol"])
    for other in (dict(logit_cap=1.0), dict(sliding_window=24)):
        assert (kern(**other).float() - out.float()).abs().max() > 1e-2


def _tree_functions(name, kernel_fn, core_fn):
    """The warpgroup and the CUDA-core kernel functions of an extend build,
    each split into its TREE = false and TREE = true instantiations (the
    template's last argument; in the GQA kernels the last but ALIBI, here
    false), with their HGMMA counts and their resource
    use (``cuobjdump -res-usage`` of the built library: REG, and STACK, the
    bytes a thread spills to; the library may come from an earlier build,
    whose nvcc log this process never saw)."""
    import os
    import re
    import subprocess

    from semi_pd_tpu_torch.kernels import find_nvcc, sass_mma_counts

    k = KERNELS[name]
    k.fn()
    counts = sass_mma_counts(k, op="HGMMA")
    cuobjdump = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-res-usage", str(k.lib_path())], capture_output=True,
                          text=True, check=True).stdout
    usage = {m.group(1): dict(registers=int(m.group(2)), stack=int(m.group(3)))
             for m in re.finditer(r"Function (\S+):\s+REG:(\d+) STACK:(\d+)", text)}
    out = {}
    for fn in (kernel_fn, core_fn):
        for tree in (False, True):
            tag = f"Lb{int(tree)}E" + ("Lb0EE" if kernel_fn == "rpa_extend_wgmma_kernel" else "E")
            out[fn, tree] = {f: (counts.get(f), usage.get(f, {})) for f in counts
                             if fn + "I" in f and tag in f}
    return out


@pytest.mark.parametrize("name,kernel_fn,core_fn", [
    ("rpa_extend_aligned_256", "rpa_extend_wgmma_kernel", "rpa_extend_kernel"),
    ("rpa_extend_mla_288", "rpa_extend_mla_wgmma_kernel", "rpa_extend_mla_kernel")])
def test_tree_instantiations_of_the_256_and_288_extends(cuda_device, name, kernel_fn, core_fn):
    """The _256 and _288 extends hold both instantiations of each kernel:
    the bf16-q pairs' warpgroup kernel (bf16, e4m3, e5m2 KV) with HGMMA in
    its TREE = false and its TREE = true functions alike, the float32
    pair's CUDA-core kernel without; the TREE = false warpgroup functions
    use no stack, so spill nothing (the tree's code leaves them as they
    were)."""
    fns = _tree_functions(name, kernel_fn, core_fn)
    for tree in (False, True):
        wg = fns[kernel_fn, tree]
        assert len(wg) == 3 and all(n for n, _ in wg.values()), (tree, wg)
        core = fns[core_fn, tree]
        assert len(core) == 1 and not any(n for n, _ in core.values()), (tree, core)
    for f, (_, u) in fns[kernel_fn, False].items():
        assert u and u["stack"] == 0, (f, u)


@pytest.mark.parametrize("build", ["rpa_extend", "rpa_extend_mla"])
def test_tree_refused_unpaired(cuda_device, build):
    c = _tree_case(cuda_device, build, "bfloat16")
    kern, _ = _tree_fns(build, c)
    with pytest.raises(ValueError, match="go together"):
        kern(win_base=None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "fp8_e4m3"])
def test_mla_extend_tree_and_treeless_instantiations(cuda_device, dtype):
    """rpa_extend_mla's two instantiations on the same tree verify inputs
    (every dead slot NaN): without the tree its TREE = false code matches
    the plain causal extend, with it the TREE = true code matches the plain
    masked one, one launch each, and the two answers differ."""
    c = _tree_case(cuda_device, "rpa_extend_mla", dtype)
    kern, plain = _tree_fns("rpa_extend_mla", c)
    k = KERNELS["rpa_extend_mla"]
    before = k.launches
    causal, masked = kern(spec_anc=None, win_base=None), kern()
    torch.cuda.synchronize()
    assert k.launches == before + 2
    assert torch.isfinite(causal).all() and torch.isfinite(masked).all()
    torch.testing.assert_close(causal.float(), plain(spec_anc=None, win_base=None).float(),
                               rtol=c["tol"], atol=c["tol"])
    torch.testing.assert_close(masked.float(), plain().float(), rtol=c["tol"], atol=c["tol"])
    assert (causal.float() - masked.float()).abs().max() > 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "fp8_e4m3"])
@pytest.mark.parametrize("kind", ["decode", "extend"])
def test_merged_pair_at_hkv8_matches_plain(cuda_device, kind, dtype):
    """The merged decode and extend at the 1B-class draft pool's geometry
    (Hq 32, Hkv 8: G 4, which the merged builds serve only for the draft)
    against their plain versions."""
    dt = torch.float32 if dtype == "float32" else torch.bfloat16
    case = _decode_case if kind == "decode" else _extend_case
    q, pool, pt, kvl, meta = case(cuda_device, dt, kv_dtype=FP8.get(dtype, dt), merged=True,
                                  hq=32, hkv=8)
    kw = _opts("plain", 0.125)
    k = KERNELS["rpa_" + kind + "_merged"]
    before = k.launches
    if kind == "decode":
        out = rpa_packed.ragged_paged_attention_packed(q, pool, 1, pt, kvl, **kw)
        ref = rpa_packed.ragged_paged_attention_packed_plain(q, pool, 1, pt, kvl, **kw)
    else:
        out = rpa.ragged_paged_attention_extend(q, pool, 1, pt, kvl, meta, **kw)
        ref = rpa.ragged_paged_attention_extend_plain(q, pool, 1, pt, kvl, meta, **kw)
    torch.cuda.synchronize()
    assert k.launches == before + 1
    tol = 1e-4 if dt == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("algo", ["NGRAM", "EAGLE", "EAGLE-tree", "NEXTN", "NEXTN-tree"])
def test_spec_engine_on_cuda_matches_cpu(cuda_device, algo):
    """A speculating Engine on the card (float32; a Llama target on the
    chunked pool with the EAGLE draft's 5D pool at Hkv 8, or for NEXTN a
    DeepSeek-V2 target on the latent pool with NextN's one-layer latent
    pool) gives the greedy tokens and the accepted drafts of the same
    Engine on the CPU holding the same target and draft parameters, and
    launches only the speculating path's builds (never the target's
    decode). The weights are made predictive (the target's final norm ones,
    the draft's fc or eh_proj passing the token embedding, NextN's norms
    ones), so that drafts are accepted and the rounds run their accepted
    paths."""
    spec = dict(speculative_algorithm=algo.split("-")[0], speculative_num_draft_tokens=4,
                speculative_eagle_topk=4 if algo.endswith("tree") else 1)
    serve = dict(random_weights=True, page_size=PS, max_total_tokens=2048,
                 chunked_prefill_size=64, **spec)
    nextn = algo.startswith("NEXTN")
    cfg = dict(_deepseek_cfg() if nextn else _llama_cfg(D, num_kv_heads=8), vocab_size=64)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 64, size=n).tolist() for n in (20, 100, 37)]
    sp = SamplingParams(max_new_tokens=16, temperature=0.0, ignore_eos=True)
    gpu = Engine(ServerArgs(**serve), ModelConfig(**cfg))
    cpu = Engine(ServerArgs(device="cpu", **serve), ModelConfig(**cfg), device="cpu")
    params = gpu.runner.model.params_tree()
    params["final_norm"] = np.ones_like(params["final_norm"])
    for eng in (gpu, cpu):
        eng.runner.model.load_jax_params(params)
    if gpu.runner.draft_model is not None:
        H = cfg["hidden_size"]
        draft = gpu.runner.draft_model.params_tree()
        fc = draft["eh_proj" if nextn else "fc"]["w"]
        fc[H:] *= 0.01
        fc[:H] = np.eye(H)
        if nextn:
            for k in ("enorm", "hnorm", "head_norm"):
                draft[k] = np.ones_like(draft[k])
        for eng in (gpu, cpu):
            eng.runner.draft_model.load_jax_params(draft)
    for k in KERNELS.values():
        k.launches = 0
    got = gpu.generate(input_ids=prompts, sampling_params=sp)
    launched = {n for n, k in KERNELS.items() if k.launches}
    want = {"NGRAM": {"rpa_extend"}, "EAGLE": {"rpa_extend", "rpa_decode_merged"},
            "EAGLE-tree": {"rpa_extend", "rpa_decode_merged", "rpa_extend_merged"},
            # the target's verify and NextN's tree draft steps share the MLA
            # extend; its chain draft and refresh steps take the MLA decode
            "NEXTN": {"rpa_extend_mla", "rpa_decode_mla"},
            "NEXTN-tree": {"rpa_extend_mla", "rpa_decode_mla"}}[algo]
    assert launched == want
    ref = cpu.generate(input_ids=prompts, sampling_params=sp)
    assert [o["output_ids"] for o in got] == [o["output_ids"] for o in ref]
    assert gpu.scheduler.n_spec_accepted == cpu.scheduler.n_spec_accepted > 0
    assert gpu.flush_cache() and cpu.flush_cache()


def test_graph_capture_collects_first_and_holds_the_collector_off(cuda_device):
    """A dropped runner's graphs live in a reference cycle until the
    collector frees them, and freeing a graph's memory inside another
    capture invalidates that capture (an fp8 engine twin above met it once
    in four runs): the backend collects before a capture and holds the
    collector off during it."""
    import gc
    import weakref

    from semi_pd_tpu_torch.runtime.cuda_graph_runner import CudaGraphBackend

    gen = torch.Generator(device=cuda_device)
    x = torch.arange(1024, device=cuda_device, dtype=torch.float32)
    old_graph, _ = CudaGraphBackend(cuda_device, gen).capture(lambda: x + 1)

    class Holder:
        pass

    h = Holder()
    h.graph, h.me = old_graph, h  # a dead cycle holding a captured graph
    alive = weakref.ref(h)
    del h, old_graph
    seen = []

    def body():
        seen.append((gc.isenabled(), alive() is None))
        return x * 2

    graph, out = CudaGraphBackend(cuda_device, gen).capture(body)
    graph.replay()
    torch.cuda.synchronize()
    assert seen == [(False, True)] and gc.isenabled()
    assert torch.equal(out, x * 2)


# ------------------------------------------- MiniCPM3's latent geometry (288)
# the _288 builds: MiniCPM3's latent row (256 + 32), V its first 256; its
# 40 query heads in groups of 16 / 16 / 8, and DeepSeek-V2-Lite's 16
DLAT288, V288 = 288, 256
BUILDS288 = {"decode": "rpa_decode_mla_288", "stream": "rpa_decode_stream_mla_288",
             "extend": "rpa_extend_mla_288"}
CASES288 = [(kind, opt) for kind in BUILDS288 for opt in ("plain", "softcap", "window")
            if not (kind == "stream" and opt == "window")]


def _case288(case, dev, dtype, kv_dtype, hq):
    return case(dev, dtype, latent=True, dlat=DLAT288, hq_mla=hq, kv_dtype=kv_dtype)


def _fns288(kind):
    """The wrapper and its plain version for one kind on the latent pool."""
    if kind == "extend":
        return rpa.ragged_paged_attention_extend, rpa.ragged_paged_attention_extend_plain
    fn = (rpa_packed.ragged_paged_attention_packed if kind == "decode"
          else rpa_stream.ragged_paged_attention_stream)
    return (lambda q, kv, layer, pt, kvl, meta, **kw: fn(q, kv, layer, pt, kvl, **kw),
            lambda q, kv, layer, pt, kvl, meta, **kw:
            rpa_packed.ragged_paged_attention_packed_plain(q, kv, layer, pt, kvl, **kw))


@pytest.mark.parametrize("hq", [40, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "fp8_e4m3", "fp8_e5m2"])
@pytest.mark.parametrize("kind,opt", CASES288, ids=[f"{k}-{o}" for k, o in CASES288])
def test_mla288_kernel_matches_plain(cuda_device, kind, opt, dtype, hq):
    """The three _288 builds (fp8 = bf16 q over fp8 latent rows) against
    their plain versions on layer 1 of the pool, at MiniCPM3's 40 heads and
    at 16, every dead slot NaN (none is read); one launch of the build
    named for the width; the extend case has q_len 140 > 128 and a padded
    batch row; rows with kv_len 0 are zeros."""
    dt = torch.float32 if dtype == "float32" else torch.bfloat16
    case = _extend_case if kind == "extend" else _decode_case
    q, pool, pt, kvl, meta = _case288(case, cuda_device, dt, FP8.get(dtype, dt), hq)
    _poison_dead_slots(pool, pt, kvl, 1)
    kw = dict(_opts(opt, DLAT288 ** -0.5), v_dim=V288)
    if kind == "stream":
        kw.pop("sliding_window")
    fn, plain = _fns288(kind)
    k = KERNELS[BUILDS288[kind]]
    before = k.launches
    out = fn(q, pool, 1, pt, kvl, meta, **kw)
    ref = plain(q, pool, 1, pt, kvl, meta, **kw)
    torch.cuda.synchronize()
    assert k.launches == before + 1
    assert out.shape == ref.shape == (q.shape[0], hq, V288)
    assert torch.isfinite(out).all()
    if kind != "extend":
        assert not out[kvl == 0].any()
    tol = 1e-4 if dt == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("hq", [40, 16])
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "fp8_e4m3", "fp8_e5m2"])
@pytest.mark.parametrize("batch", ["few", "many", *STREAM_BATCHES])
def test_mla288_decodes_agree_bit_for_bit_whatever_the_batch(cuda_device, batch, kv_dtype, hq):
    """With bf16 q the _288 packed and streaming decodes give the same bits,
    over bf16 and over fp8 latent rows, at both head counts (the uneven
    third group of 8 at 40 included), and a request decoded alone gives the
    bits it gets in the batch."""
    bf = torch.bfloat16
    extra = dict(latent=True, dlat=DLAT288, hq_mla=hq, kv_dtype=FP8.get(kv_dtype, bf))
    if batch in STREAM_BATCHES:
        lens = STREAM_BATCHES[batch]
        q, kv, pt, kvl, _ = _case(11, [1] * len(lens), lens, cuda_device, bf, **extra)
    else:
        case = _decode_case if batch == "few" else _many_case
        q, kv, pt, kvl, _ = case(cuda_device, bf, **extra)
    _poison_dead_slots(kv, pt, kvl, 1)
    kw = dict(page_size=PS, scale=DLAT288 ** -0.5, v_dim=V288)
    packed = rpa_packed.ragged_paged_attention_packed(q, kv, 1, pt, kvl, **kw)
    stream = rpa_stream.ragged_paged_attention_stream(q, kv, 1, pt, kvl, **kw)
    again = rpa_packed.ragged_paged_attention_packed(q, kv, 1, pt, kvl, **kw)
    torch.cuda.synchronize()
    assert torch.equal(packed, stream) and torch.equal(packed, again)
    lens = kvl.tolist()
    for b in sorted({0, len(lens) // 2, int(np.argmax(lens))}):
        pages = max(1, -(-lens[b] // PS))
        alone = rpa_packed.ragged_paged_attention_packed(
            q[b:b + 1].contiguous(), kv, 1, pt[b:b + 1, :pages].contiguous(),
            kvl[b:b + 1].contiguous(), **kw)
        torch.cuda.synchronize()
        assert torch.equal(alone[0], packed[b]), (b, lens[b])


@pytest.mark.parametrize("hq", [40, 16])
@pytest.mark.parametrize("kv", ["bfloat16", "fp8_e4m3"])
def test_mla288_extend_repeats_bitwise_and_leaves_unowned_rows_zero(cuda_device, kv, hq):
    """The _288 extend's warpgroup kernel (bf16 q): a second run on the same
    inputs is bitwise equal, and the bucket-padding rows no work-list entry
    owns stay zero, with 40 heads packed 1.6 tokens to a 64-row tile."""
    q, pool, pt, kvl, meta = _case288(_extend_case, cuda_device, torch.bfloat16,
                                      FP8.get(kv, torch.bfloat16), hq)
    kw = dict(page_size=PS, scale=DLAT288 ** -0.5, v_dim=V288)
    a = rpa.ragged_paged_attention_extend(q, pool, 1, pt, kvl, meta, **kw)
    b = rpa.ragged_paged_attention_extend(q, pool, 1, pt, kvl, meta, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    n = int(meta.q_lens.sum())
    assert a[:n].abs().sum() > 0 and not a[n:].any()


def test_mla288_builds_run_on_the_tensor_cores(cuda_device):
    """The _288 libraries disassembled: the packed and the streaming
    decode's bf16-q instantiations (bf16, e4m3 and e5m2 rows) run HMMA in
    their block-tile kernels and their float32 pair's CUDA-core kernel
    none; the extend's three run HGMMA in its warpgroup kernel, in its
    TREE = false and its TREE = true instantiation alike (six functions,
    the CUDA-core kernel two)."""
    from semi_pd_tpu_torch.kernels import sass_mma_counts

    for name, mma_fn, core_fn, op in (
            ("rpa_decode_mla_288", "rpa_decode_mla_mma_kernel", "rpa_decode_mla_kernel",
             r"HG?MMA"),
            ("rpa_decode_stream_mla_288", "rpa_stream_mla_mma_kernel", "rpa_stream_mla_kernel",
             r"HG?MMA"),
            ("rpa_extend_mla_288", "rpa_extend_mla_wgmma_kernel", "rpa_extend_mla_kernel",
             "HGMMA")):
        KERNELS[name].fn()
        counts = sass_mma_counts(KERNELS[name], op=op)
        extend = name == "rpa_extend_mla_288"
        mma = [n for f, n in counts.items() if mma_fn in f]
        assert len(mma) == (6 if extend else 3) and all(mma), (name, counts)
        core = [n for f, n in counts.items() if core_fn in f]
        assert len(core) == (2 if extend else 1) and not any(core), (name, counts)
        if extend:  # the TREE = true instantiations
            assert len([f for f in counts if mma_fn in f and "Lb1E" in f]) == 3, counts


def test_mla288_extend_refuses_a_tree(cuda_device):
    """No longer refused: a speculation tree on the 288 extend launches its
    TREE instantiation once, on an extend batch at Hq 40 (q_len 140 > 128,
    a padded row), and matches the plain masked extend."""
    q, pool, pt, kvl, meta = _case288(_extend_case, cuda_device, torch.bfloat16,
                                      torch.bfloat16, 40)
    k = KERNELS["rpa_extend_mla_288"]
    before = k.launches
    win = (kvl - meta.q_lens).clamp(min=0).to(torch.int32)  # each request's first new row
    kw = dict(page_size=PS, scale=DLAT288 ** -0.5, v_dim=V288, spec_anc=(1, 3, 5),
              win_base=win)
    out = rpa.ragged_paged_attention_extend(q, pool, 1, pt, kvl, meta, **kw)
    ref = rpa.ragged_paged_attention_extend_plain(q, pool, 1, pt, kvl, meta, **kw)
    torch.cuda.synchronize()
    assert k.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("kind", ["decode", "stream"])
@pytest.mark.parametrize("dtype", ["bfloat16", "fp8_e4m3"])
def test_mla576_decodes_take_uneven_head_groups(cuda_device, kind, dtype):
    """The 576 latent decodes at 40 query heads (groups 16 / 16 / 8, which
    they refused before the groups became uneven) against their plain
    version, and the packed equal to the stream bitwise; at 16 heads they
    are the tests above, unchanged."""
    dt = torch.bfloat16
    q, pool, pt, kvl, _ = _decode_case(cuda_device, dt, latent=True, hq_mla=40,
                                       kv_dtype=FP8.get(dtype, dt))
    _poison_dead_slots(pool, pt, kvl, 1)
    kw = dict(page_size=PS, scale=DLAT ** -0.5, v_dim=V_DIM)
    k = KERNELS["rpa_decode_mla" if kind == "decode" else "rpa_decode_stream_mla"]
    before = k.launches
    fn = (rpa_packed.ragged_paged_attention_packed if kind == "decode"
          else rpa_stream.ragged_paged_attention_stream)
    out = fn(q, pool, 1, pt, kvl, **kw)
    other = (rpa_stream.ragged_paged_attention_stream if kind == "decode"
             else rpa_packed.ragged_paged_attention_packed)(q, pool, 1, pt, kvl, **kw)
    ref = rpa_packed.ragged_paged_attention_packed_plain(q, pool, 1, pt, kvl, **kw)
    torch.cuda.synchronize()
    assert k.launches == before + 1 and torch.equal(out, other)
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("decode_stream", [False, True], ids=["packed", "stream"])
def test_engine_minicpm3_latent288_on_cuda_matches_cpu(cuda_device, decode_stream):
    """The small MiniCPM3 in float32 on the card through the _288 builds
    (and no other kernel) gives the CPU Engine's greedy tokens, with the
    packed and with the streaming decode."""
    dec = "rpa_decode_stream_mla_288" if decode_stream else "rpa_decode_mla_288"
    _engines_agree(cuda_device, _minicpm3_cfg(), [dec, "rpa_extend_mla_288"],
                   decode_stream=decode_stream)


# ------------------------------------------------- head_dim 256 (Gemma-2)
# the three _256 builds at Gemma-2-9B's heads (Hq 16, Hkv 8: G = 2) on the
# 5D pool [L, 2, S, 8, 256], every slot that holds no live position NaN
HQ256, HKV256, D256 = 16, 8, 256
CASES256 = [(k, o) for k in ("decode", "extend") for o in ("plain", "softcap", "window")] + [
    ("stream", "plain"), ("stream", "softcap")]


def _case256(case, dev, dtype, kv_dtype):
    q, pool, pt, kvl, meta = case(dev, dtype, aligned=True, aligned_dim=D256, hq=HQ256,
                                  hkv=HKV256, kv_dtype=kv_dtype)
    _poison_dead_slots(pool, pt, kvl, 1)
    return q, pool, pt, kvl, meta


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "fp8_e4m3", "fp8_e5m2"])
@pytest.mark.parametrize("kind,opt", CASES256, ids=[f"{k}-{o}" for k, o in CASES256])
def test_aligned256_kernel_matches_plain(cuda_device, kind, opt, dtype):
    """rpa_decode_aligned_256, rpa_extend_aligned_256 and
    rpa_decode_stream_aligned_256 against their plain versions on layer 1
    of the pool, with every (q, KV) pair they are built for, softcap 1.0 and
    a window of 24 (the stream has none): one launch each, zeros on kv_len-0
    rows, a second run bitwise equal."""
    dt = torch.float32 if dtype == "float32" else torch.bfloat16
    case = _extend_case if kind == "extend" else _decode_case
    q, pool, pt, kvl, meta = _case256(case, cuda_device, dt, FP8.get(dtype, dt))
    kw = _opts(opt, D256 ** -0.5)
    name = {"decode": "rpa_decode_aligned_256", "extend": "rpa_extend_aligned_256",
            "stream": "rpa_decode_stream_aligned_256"}[kind]
    if kind == "decode":
        fn = rpa_packed.ragged_paged_attention_packed
        plain = rpa_packed.ragged_paged_attention_packed_plain
    elif kind == "stream":
        kw.pop("sliding_window")
        fn = rpa_stream.ragged_paged_attention_stream
        plain = rpa_packed.ragged_paged_attention_packed_plain
    else:
        fn = functools.partial(rpa.ragged_paged_attention_extend, meta=meta)
        plain = functools.partial(rpa.ragged_paged_attention_extend_plain, meta=meta)
    k = KERNELS[name]
    before = k.launches
    out = fn(q, pool, 1, pt, kvl, **kw)
    again = fn(q, pool, 1, pt, kvl, **kw)
    ref = plain(q, pool, 1, pt, kvl, **kw)
    torch.cuda.synchronize()
    assert k.launches == before + 2
    assert torch.equal(out, again)
    if kind != "extend":
        assert not out[kvl == 0].any()
    tol = 1e-4 if dt == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("batch", ["many", *STREAM_BATCHES])
@pytest.mark.parametrize("dtype", ["bfloat16", "fp8_e4m3"])
def test_aligned256_stream_cuts_requests_across_warps_and_blocks(cuda_device, dtype, batch):
    """The 256 stream's tensor-core kernel (one block an SM) over batches
    whose requests it cuts across warps and blocks, against the plain
    version, with NaN in every dead slot."""
    dt = torch.bfloat16
    kv_dt = FP8.get(dtype, dt)
    if batch in STREAM_BATCHES:
        lens = STREAM_BATCHES[batch]
        q, pool, pt, kvl, _ = _case(11, [1] * len(lens), lens, cuda_device, dt,
                                    kv_dtype=kv_dt, aligned=True, aligned_dim=D256,
                                    hq=HQ256, hkv=HKV256)
        _poison_dead_slots(pool, pt, kvl, 1)
    else:
        q, pool, pt, kvl, _ = _case256(_many_case, cuda_device, dt, kv_dt)
    kw = dict(page_size=PS, scale=D256 ** -0.5, logit_cap=1.0)
    out = rpa_stream.ragged_paged_attention_stream(q, pool, 1, pt, kvl, **kw)
    ref = rpa_packed.ragged_paged_attention_packed_plain(q, pool, 1, pt, kvl, **kw)
    torch.cuda.synchronize()
    assert not out[kvl == 0].any()
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("kv", ["bfloat16", "fp8_e4m3"])
def test_aligned256_extend_heads_per_kv_head(cuda_device, kv, G):
    """The 256 extend's warpgroup kernel at 1, 2 and 4 query heads per KV
    head (Hkv 4), a window that cuts, against the plain version."""
    dt = torch.bfloat16
    q, pool, pt, kvl, meta = _case(13, MMA_Q_LENS, [140, 60, 9, 300, 700], cuda_device, dt,
                                   pad_T=9, aligned=True, aligned_dim=D256, hq=4 * G, hkv=4,
                                   kv_dtype=FP8.get(kv, dt))
    _poison_dead_slots(pool, pt, kvl, 1)
    kw = dict(page_size=PS, scale=D256 ** -0.5, logit_cap=1.0, sliding_window=100)
    out = rpa.ragged_paged_attention_extend(q, pool, 1, pt, kvl, meta, **kw)
    ref = rpa.ragged_paged_attention_extend_plain(q, pool, 1, pt, kvl, meta, **kw)
    torch.cuda.synchronize()
    assert not out[sum(MMA_Q_LENS):].any()
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1e-2)


def test_aligned256_builds_run_on_the_tensor_cores(cuda_device):
    """The _256 libraries disassembled: the extend's bf16-q instantiations
    (bf16, e4m3, e5m2 KV) run HGMMA in its warpgroup kernel, in its TREE =
    false and its TREE = true instantiation alike, the packed and the
    streaming decode's run HMMA, with head groups (GROUPS) and without;
    each float32 pair's CUDA-core kernel none."""
    from semi_pd_tpu_torch.kernels import sass_mma_counts

    for name, mma_fn, core_fn, op in (
            ("rpa_decode_aligned_256", "rpa_decode_mma_kernel", "rpa_decode_kernel", r"HG?MMA"),
            ("rpa_decode_stream_aligned_256", "rpa_stream_mma_kernel", "rpa_stream_kernel",
             r"HG?MMA"),
            ("rpa_extend_aligned_256", "rpa_extend_wgmma_kernel", "rpa_extend_kernel", "HGMMA")):
        KERNELS[name].fn()
        counts = sass_mma_counts(KERNELS[name], op=op)
        extend = name == "rpa_extend_aligned_256"
        mma = [n for f, n in counts.items() if mma_fn in f]
        assert len(mma) == 6 and all(mma), (name, counts)
        core = [n for f, n in counts.items() if core_fn in f]
        assert len(core) == (2 if extend else 1) and not any(core), (name, counts)
        if extend:  # the TREE = true instantiations
            assert len([f for f in counts if mma_fn in f and "Lb1E" in f]) == 3, counts


def test_aligned256_extend_refuses_a_tree(cuda_device):
    """No longer refused: a speculation tree on the 256 extend launches its
    TREE instantiation once, on an extend batch (q_len 140 > 128, a padded
    row) with softcap 1.0 and a window of 24, and matches the plain masked
    extend."""
    q, pool, pt, kvl, meta = _case256(_extend_case, cuda_device, torch.bfloat16, torch.bfloat16)
    k = KERNELS["rpa_extend_aligned_256"]
    before = k.launches
    win = (kvl - meta.q_lens).clamp(min=0).to(torch.int32)  # each request's first new row
    kw = dict(page_size=PS, scale=D256 ** -0.5, logit_cap=1.0, sliding_window=24,
              spec_anc=(1, 3, 5), win_base=win)
    out = rpa.ragged_paged_attention_extend(q, pool, 1, pt, kvl, meta, **kw)
    ref = rpa.ragged_paged_attention_extend_plain(q, pool, 1, pt, kvl, meta, **kw)
    torch.cuda.synchronize()
    assert k.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1e-2)


# ------------------------- the Llama-family strings, Gemma-1, the GQA MoE families
# the GQA builds at the head groups of those models: one query head per KV
# head (G = 1: Qwen1.5-MoE-A2.7B's and OLMoE-1B-7B's 16 / 16 at head_dim 128,
# Gemma-7B's at 256) and eight (G = 8: Qwen3-30B-A3B's 32 / 4 at 128)
HEAD_GROUPS = [(128, 16, 16), (256, 16, 16), (128, 32, 4)]
GQA_BUILDS = {"decode": "rpa_decode_aligned", "stream": "rpa_decode_stream_aligned",
              "extend": "rpa_extend_aligned"}


@pytest.mark.parametrize("kv", ["bfloat16", "fp8_e4m3"])
@pytest.mark.parametrize("kind", ["decode", "stream", "extend"])
@pytest.mark.parametrize("dim,hq,hkv", HEAD_GROUPS, ids=["g1-d128", "g1-d256", "g8-d128"])
def test_gqa_builds_at_one_and_eight_heads_per_kv_head(cuda_device, dim, hq, hkv, kind, kv):
    """The aligned builds (head_dim 128) and their _256 twins at G = 1 and
    the aligned builds at G = 8, bf16 q over bf16 and e4m3 KV, every dead
    slot NaN, against their plain versions: one launch, zeros on kv_len-0
    rows."""
    dt = torch.bfloat16
    case = _extend_case if kind == "extend" else _decode_case
    q, pool, pt, kvl, meta = case(cuda_device, dt, aligned=True, aligned_dim=dim, hq=hq,
                                  hkv=hkv, kv_dtype=FP8.get(kv, dt))
    _poison_dead_slots(pool, pt, kvl, 1)
    kw = dict(page_size=PS, scale=dim ** -0.5)
    if kind == "decode":
        fn = rpa_packed.ragged_paged_attention_packed
        plain = rpa_packed.ragged_paged_attention_packed_plain
    elif kind == "stream":
        fn = rpa_stream.ragged_paged_attention_stream
        plain = rpa_packed.ragged_paged_attention_packed_plain
    else:
        fn = functools.partial(rpa.ragged_paged_attention_extend, meta=meta)
        plain = functools.partial(rpa.ragged_paged_attention_extend_plain, meta=meta)
    k = KERNELS[GQA_BUILDS[kind] + ("_256" if dim == 256 else "")]
    before = k.launches
    out = fn(q, pool, 1, pt, kvl, **kw)
    ref = plain(q, pool, 1, pt, kvl, **kw)
    torch.cuda.synchronize()
    assert k.launches == before + 1
    assert torch.isfinite(out).all()
    if kind != "extend":
        assert not out[kvl == 0].any()
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1e-2)


def _family_cfg(arch, **kw):
    """A small config of one of the slice's architectures (2 layers, hidden
    256, head_dim 128, 4 / 4 heads), float32."""
    return {**dict(architecture=arch, vocab_size=512, hidden_size=256, intermediate_size=512,
                   num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
                   head_dim=128, context_length=512, dtype="float32"), **kw}


# Qwen1.5-MoE-A2.7B's routing: 60 experts, top-4, a shared expert
QWEN2_MOE = dict(num_experts=60, num_experts_per_tok=4, moe_intermediate_size=64,
                 num_shared_experts=2)
FAMILY_ENGINES = {
    "qwen3": (_family_cfg("Qwen3ForCausalLM", num_key_value_heads=1), "aligned"),
    "qwen2_bias": (_family_cfg("Qwen2ForCausalLM", attention_bias=True), "aligned"),
    "gemma": (_family_cfg("GemmaForCausalLM", head_dim=256, hidden_act="gelu"), "256"),
    "qwen2_moe": (_family_cfg("Qwen2MoeForCausalLM", **QWEN2_MOE), "aligned"),
    "olmoe": (_family_cfg("OlmoeForCausalLM", num_experts=8, num_experts_per_tok=4,
                          moe_intermediate_size=64), "aligned"),
}


@pytest.mark.parametrize("family", list(FAMILY_ENGINES))
def test_engine_families_on_cuda_match_cpu(cuda_device, family):
    """Qwen3 (G = 4, per-head q/k norms), Qwen2 (its bias, G = 1), Gemma-1
    (G = 1 at head_dim 256), Qwen2-MoE (60 experts, top-4, the shared
    expert; G = 1) and OLMoE (full-width q/k norms) in float32 on the card
    give the CPU Engine's greedy tokens through the aligned (or _256)
    builds alone."""
    cfg, build = FAMILY_ENGINES[family]
    suffix = "_256" if build == "256" else ""
    _engines_agree(cuda_device, cfg, ["rpa_decode_aligned" + suffix,
                                      "rpa_extend_aligned" + suffix])


def test_moe_decode_graph_replays_the_eager_step_bitwise(cuda_device):
    """A bf16 Qwen2-MoE with Qwen1.5-MoE-A2.7B's 60 experts (top-4, the
    shared expert behind its gate) at G = 1: a replayed decode step gives
    the eager step's tokens and log-probs bitwise, the capture counts no
    launch and the replay its L decode launches, and neither syncs the
    host (the experts' row counts are made on the card)."""
    cfg = dict(_family_cfg("Qwen2MoeForCausalLM", **QWEN2_MOE), dtype="bfloat16")
    eng = Engine(ServerArgs(random_weights=True, page_size=PS, max_total_tokens=4096,
                            chunked_prefill_size=64), ModelConfig(**cfg))
    _fill_pool(eng, cuda_device, seed=0)
    runner = eng.runner
    L = cfg["num_hidden_layers"]
    for k in KERNELS.values():
        k.launches = 0
    step = _graph_batch(eng, [33, 260, 9, 77, 1, 140], seed=1)
    want = _eager_step(runner, *step, is_decode=True)
    got = runner.step_packed_raw(*step, is_decode=True)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.isfinite(got[1]).all()
    (g,) = runner.graphs.graphs.values()
    assert g.tally == {"rpa_decode_aligned": L}
    assert KERNELS["rpa_decode_aligned"].launches == 2 * L
    torch.cuda.set_sync_debug_mode("error")
    try:
        _eager_step(runner, *step, is_decode=True)
        runner.step_packed_raw(*step, is_decode=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def _gemma2_cfg():
    return dict(architecture="Gemma2ForCausalLM", vocab_size=512, hidden_size=256,
                intermediate_size=512, num_hidden_layers=3, num_attention_heads=8,
                num_key_value_heads=HKV, head_dim=256, context_length=512,
                sliding_window=24, query_pre_attn_scalar=128, attn_logit_softcap=1.0,
                logit_softcap=5.0, hidden_act="gelu_pytorch_tanh", dtype="float32")


@pytest.mark.parametrize("decode_stream", [False, True], ids=["packed", "stream"])
def test_engine_gemma2_on_cuda_matches_cpu(cuda_device, decode_stream):
    """A small Gemma-2 in float32 (head_dim 256, a window of 24 on the even
    layers, softcaps) on the card through the _256 builds gives the CPU
    Engine's greedy tokens; with decode_stream its windowed layers keep the
    packed decode and its full ones stream."""
    kernels = ["rpa_decode_aligned_256", "rpa_extend_aligned_256"]
    if decode_stream:
        kernels.append("rpa_decode_stream_aligned_256")
    _engines_agree(cuda_device, _gemma2_cfg(), kernels, decode_stream=decode_stream)


@pytest.mark.parametrize("algo", ["EAGLE-gemma2", "EAGLE-tree-gemma2", "NEXTN-minicpm3",
                                  "NEXTN-tree-minicpm3"])
def test_spec_engine_gemma2_and_minicpm3_on_cuda_matches_cpu(cuda_device, algo):
    """Speculating Engines on the card (float32) with the two targets whose
    tree verify takes the _256 and _288 extends: a small Gemma-2 (head_dim
    256, a window of 24, softcaps) with the EAGLE draft on a one-layer 5D
    pool at head_dim 256, and a small MiniCPM3 (40 heads over the 288
    latent row, longrope) with its NextN draft on a one-layer latent pool;
    chain and tree (topk 4, 4 draft tokens: 29 nodes, longer than the
    window). Each gives the greedy tokens and the accepted drafts of the
    same Engine on the CPU holding the same target and draft parameters,
    and launches only its path's builds: the target's extend per prefill
    chunk and per verify, the draft pool's decode per chain draft or
    refresh step and its extend per tree draft step (the same _256 or _288
    extend), never another kernel. The weights are made predictive (the
    final norm the identity: Gemma-2's (1 + w) at w = 0 with its embedding,
    and so its tied head, times 4; the draft's fc or eh_proj passing the
    token embedding, NextN's norms ones)."""
    tree = "-tree" in algo
    gemma = algo.endswith("gemma2")
    spec = dict(speculative_algorithm=algo.split("-")[0], speculative_num_draft_tokens=4,
                speculative_eagle_topk=4 if tree else 1)
    serve = dict(random_weights=True, page_size=PS, max_total_tokens=2048,
                 chunked_prefill_size=64, **spec)
    cfg = _gemma2_cfg() if gemma else _minicpm3_cfg()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, size=n).tolist() for n in (20, 100, 37)]
    sp = SamplingParams(max_new_tokens=16, temperature=0.0, ignore_eos=True)
    gpu = Engine(ServerArgs(**serve), ModelConfig(**cfg))
    cpu = Engine(ServerArgs(device="cpu", **serve), ModelConfig(**cfg), device="cpu")
    params = gpu.runner.model.params_tree()
    if gemma:
        params["final_norm"] = np.zeros_like(params["final_norm"])
        params["embed"]["w"] = params["embed"]["w"] * 4.0
    else:
        params["final_norm"] = np.ones_like(params["final_norm"])
    H = cfg["hidden_size"]
    draft = gpu.runner.draft_model.params_tree()
    fc = draft["fc" if gemma else "eh_proj"]["w"]
    fc[H:] *= 0.01
    fc[:H] = np.eye(H)
    if not gemma:
        for k in ("enorm", "hnorm", "head_norm"):
            draft[k] = np.ones_like(draft[k])
    for eng in (gpu, cpu):
        eng.runner.model.load_jax_params(params)
        eng.runner.draft_model.load_jax_params(draft)
        eng.runner.set_spec_thresholds()
    for k in KERNELS.values():
        k.launches = 0
    got = gpu.generate(input_ids=prompts, sampling_params=sp)
    launched = {n for n, k in KERNELS.items() if k.launches}
    width = "aligned_256" if gemma else "mla_288"
    assert launched == {f"rpa_extend_{width}", f"rpa_decode_{width}"}, launched
    ref = cpu.generate(input_ids=prompts, sampling_params=sp)
    assert [o["output_ids"] for o in got] == [o["output_ids"] for o in ref]
    assert gpu.scheduler.n_spec_accepted == cpu.scheduler.n_spec_accepted > 0
    if tree:
        assert gpu.runner.spec_counts["draft_tree"] > 0
    assert gpu.flush_cache() and cpu.flush_cache()


# --------------------------- the Llama variants: ALiBi, G = 6 and 16, Hkv 36
def _alibi(hq, dev):
    from semi_pd_tpu_torch.models.llama_variants import alibi_slopes

    return torch.from_numpy(alibi_slopes(hq)).to(dev)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "fp8_e4m3"])
@pytest.mark.parametrize("kind", ["decode", "extend"])
@pytest.mark.parametrize("hq,hkv", [(8, 8), (8, 2)], ids=["g1", "g4"])
@pytest.mark.parametrize("opt", ["plain", "softcap"])
def test_alibi_kernels_match_plain(cuda_device, kind, dtype, hq, hkv, opt):
    """The aligned builds' ALiBi instantiations (rpa_decode_aligned_alibi,
    rpa_extend_aligned_alibi; fp8 = bf16 q over an e4m3 pool) against their
    plain versions with the same slopes, every dead slot NaN: the decode
    with a padded row, the extend with a prompt of 140 in two work-list
    entries, a chunk of 20 behind a cached prefix of 40 (a prefix hit) and
    a padded entry; with a softcap of 1 the bias comes after it. One launch
    of the ALiBi build and none of the aligned one."""
    dt = torch.float32 if dtype == "float32" else torch.bfloat16
    case = _decode_case if kind == "decode" else _extend_case
    q, pool, pt, kvl, meta = case(cuda_device, dt, aligned=True, hq=hq, hkv=hkv,
                                  kv_dtype=FP8.get(dtype, dt))
    _poison_dead_slots(pool, pt, kvl, 1)
    kw = dict(_opts(opt, D_ALIGNED ** -0.5), alibi_slopes=_alibi(hq, cuda_device))
    if kind == "decode":
        fn, plain = rpa_packed.ragged_paged_attention_packed, rpa_packed.ragged_paged_attention_packed_plain
    else:
        fn = functools.partial(rpa.ragged_paged_attention_extend, meta=meta)
        plain = functools.partial(rpa.ragged_paged_attention_extend_plain, meta=meta)
    k, base = KERNELS[f"rpa_{kind}_aligned_alibi"], KERNELS[f"rpa_{kind}_aligned"]
    before, before_base = k.launches, base.launches
    out = fn(q, pool, 1, pt, kvl, **kw)
    ref = plain(q, pool, 1, pt, kvl, **kw)
    torch.cuda.synchronize()
    assert k.launches == before + 1 and base.launches == before_base
    assert torch.isfinite(out).all()
    if kind == "decode":
        assert not out[kvl == 0].any()
    tol = 1e-4 if dtype == "float32" else 1e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    # the bias shows: the aligned build without it lands elsewhere
    kw.pop("alibi_slopes")
    assert (fn(q, pool, 1, pt, kvl, **kw).float() - ref.float()).abs().max() > 10 * tol


def test_alibi_is_refused_where_no_build_has_it(cuda_device):
    """A CUDA tensor with slopes on a build without an ALiBi instantiation
    raises, naming ROADMAP B9.6: the merged and _256 decodes and extends,
    the streaming decode; nothing launches."""
    before = {n: k.launches for n, k in KERNELS.items()}
    for kw in (dict(merged=True), dict(aligned=True, aligned_dim=256)):
        for case, fn in ((_decode_case, rpa_packed.ragged_paged_attention_packed),
                         (_extend_case, rpa.ragged_paged_attention_extend)):
            q, pool, pt, kvl, meta = case(cuda_device, torch.bfloat16, **kw)
            args = (q, pool, 1, pt, kvl) + ((meta,) if case is _extend_case else ())
            with pytest.raises(NotImplementedError, match="ROADMAP B9.6"):
                fn(*args, page_size=PS, scale=0.1, alibi_slopes=_alibi(HQ, cuda_device))
    q, pool, pt, kvl, meta = _decode_case(cuda_device, torch.bfloat16, aligned=True)
    with pytest.raises(NotImplementedError, match="ROADMAP B9.6"):
        rpa.ragged_paged_attention(q, pool, 1, pt, kvl, meta, page_size=PS, scale=0.1,
                                   stream=True, alibi_slopes=_alibi(HQ, cuda_device))
    assert {n: k.launches for n, k in KERNELS.items()} == before


@pytest.mark.parametrize("kv", ["bfloat16", "fp8_e4m3"])
@pytest.mark.parametrize("kind", ["decode", "stream", "extend"])
@pytest.mark.parametrize("hq,hkv", [(12, 2), (32, 2)], ids=["g6", "g16"])
def test_gqa_builds_at_six_and_sixteen_heads_per_kv_head(cuda_device, hq, hkv, kind, kv):
    """The aligned builds at G = 6 (a query row's packed extend rows m = r *
    6 + g cut across the 16-row warp tiles) and G = 16 (the decodes' m16
    tile full), bf16 q over bf16 and e4m3 KV, every dead slot NaN, against
    their plain versions: one launch, zeros on kv_len-0 rows."""
    dt = torch.bfloat16
    case = _extend_case if kind == "extend" else _decode_case
    q, pool, pt, kvl, meta = case(cuda_device, dt, aligned=True, hq=hq, hkv=hkv,
                                  kv_dtype=FP8.get(kv, dt))
    _poison_dead_slots(pool, pt, kvl, 1)
    kw = dict(page_size=PS, scale=D_ALIGNED ** -0.5)
    if kind == "decode":
        fn = rpa_packed.ragged_paged_attention_packed
    elif kind == "stream":
        fn = rpa_stream.ragged_paged_attention_stream
    else:
        fn = functools.partial(rpa.ragged_paged_attention_extend, meta=meta)
    plain = (functools.partial(rpa.ragged_paged_attention_extend_plain, meta=meta)
             if kind == "extend" else rpa_packed.ragged_paged_attention_packed_plain)
    k = KERNELS[GQA_BUILDS[kind]]
    before = k.launches
    out = fn(q, pool, 1, pt, kvl, **kw)
    ref = plain(q, pool, 1, pt, kvl, **kw)
    torch.cuda.synchronize()
    assert k.launches == before + 1
    assert torch.isfinite(out).all()
    if kind != "extend":
        assert not out[kvl == 0].any()
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1e-2)


def test_float32_decode_at_sixteen_heads_per_kv_head_is_refused(cuda_device):
    """float32 q at G = 16 and head_dim 128 (2048 outputs a block) is more
    than the GQA decodes' float32 kernels hold: refused naming ROADMAP B9.7,
    the packed decode and the stream alike; the extend takes it."""
    q, pool, pt, kvl, meta = _decode_case(cuda_device, torch.float32, aligned=True, hq=32,
                                          hkv=2)
    for fn in (rpa_packed.ragged_paged_attention_packed, rpa_stream.ragged_paged_attention_stream):
        with pytest.raises(NotImplementedError, match="ROADMAP B9.7"):
            fn(q, pool, 1, pt, kvl, page_size=PS, scale=0.1)
    q, pool, pt, kvl, meta = _extend_case(cuda_device, torch.float32, aligned=True, hq=32,
                                          hkv=2)
    out = rpa.ragged_paged_attention_extend(q, pool, 1, pt, kvl, meta, page_size=PS, scale=0.1)
    ref = rpa.ragged_paged_attention_extend_plain(q, pool, 1, pt, kvl, meta, page_size=PS,
                                                  scale=0.1)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "fp8_e4m3"])
@pytest.mark.parametrize("kind", ["decode", "extend"])
def test_merged_builds_at_36_kv_heads(cuda_device, kind, dtype):
    """The merged builds at MiniCPM-2B's 36 KV heads (Hq 36, head_dim 64, G
    = 1; fp8 = bf16 q over an e4m3 pool), every dead slot NaN, against
    their plain versions."""
    dt = torch.float32 if dtype == "float32" else torch.bfloat16
    case = _extend_case if kind == "extend" else _decode_case
    q, pool, pt, kvl, meta = case(cuda_device, dt, merged=True, hq=36, hkv=36,
                                  kv_dtype=FP8.get(dtype, dt))
    _poison_dead_slots(pool, pt, kvl, 1)
    kw = dict(page_size=PS, scale=D ** -0.5)
    if kind == "decode":
        out = rpa_packed.ragged_paged_attention_packed(q, pool, 1, pt, kvl, **kw)
        ref = rpa_packed.ragged_paged_attention_packed_plain(q, pool, 1, pt, kvl, **kw)
    else:
        out = rpa.ragged_paged_attention_extend(q, pool, 1, pt, kvl, meta, **kw)
        ref = rpa.ragged_paged_attention_extend_plain(q, pool, 1, pt, kvl, meta, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    tol = 1e-4 if dtype == "float32" else 1e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


# one small config per distinct forward of the slice (float32), and the
# two kernels each runs on the card
VARIANT_ENGINES = {
    "baichuan_alibi": (_family_cfg("BaichuanForCausalLM", position_embedding="ALIBI"),
                       ("rpa_decode_aligned_alibi", "rpa_extend_aligned_alibi")),
    "minicpm": (_family_cfg("MiniCPMForCausalLM", head_dim=64, scale_emb=12.0,
                            scale_depth=1.4, dim_model_base=64),
                ("rpa_decode_merged", "rpa_extend_merged")),
    "chatglm": (_family_cfg("ChatGLMModel", num_attention_heads=8, num_key_value_heads=2,
                            partial_rotary_factor=0.5),
                ("rpa_decode_aligned", "rpa_extend_aligned")),
    "glm4": (_family_cfg("Glm4ForCausalLM", partial_rotary_factor=0.5),
             ("rpa_decode_aligned", "rpa_extend_aligned")),
    "deepseek_v1": (_family_cfg("DeepseekForCausalLM", num_experts=8, num_experts_per_tok=2,
                                moe_intermediate_size=64, num_shared_experts=2,
                                first_k_dense_replace=1),
                    ("rpa_decode_aligned", "rpa_extend_aligned")),
    "grok": (_family_cfg("Grok1ForCausalLM", num_attention_heads=12, num_key_value_heads=2,
                         num_experts=4, num_experts_per_tok=2, moe_intermediate_size=64,
                         embedding_multiplier_scale=8.0, output_multiplier_scale=0.5),
             ("rpa_decode_aligned", "rpa_extend_aligned")),
    "granite": (_family_cfg("GraniteForCausalLM", embedding_multiplier=12.0,
                            attention_multiplier=0.0078125, residual_multiplier=0.22,
                            logits_scaling=16.0), ("rpa_decode_aligned", "rpa_extend_aligned")),
}


@pytest.mark.parametrize("family", list(VARIANT_ENGINES))
def test_engine_variants_on_cuda_match_cpu(cuda_device, family):
    """Each distinct forward of the slice (Baichuan's ALiBi through the
    ALiBi instantiations, MiniCPM on the merged pool, ChatGLM's interleaved
    half rope, Glm4's sandwich norms, DeepSeek-V1's dense first layer,
    Grok-1's capped router, GELU experts and softcap at G = 6, Granite's
    multipliers) in float32 on the card gives the CPU Engine's greedy tokens
    through its pool's two kernels alone."""
    cfg, kernels = VARIANT_ENGINES[family]
    _engines_agree(cuda_device, cfg, list(kernels))


# ------------------------------------- head groups past 16 heads a KV head
# (build, pool case options, query heads, KV heads, head_dim): StarCoder's
# multi-query 48 / 1 and two KV heads of 48 on the aligned build, Falcon-7B's
# 71 / 1 at head_dim 64 on the merged one (a 64-element slot row), G = 17 on
# the chunked pool (8 KV heads at 64), G = 20 on the _256 build
GROUP_CASES = [("aligned", {"aligned": True}, 48, 1, D_ALIGNED),
               ("aligned", {"aligned": True}, 96, 2, D_ALIGNED),
               ("merged", {"merged": True}, 71, 1, D),
               ("chunked", {}, 136, 8, D),
               ("aligned256", {"aligned": True, "aligned_dim": 256}, 40, 2, 256)]
GROUP_BUILDS = {"aligned": ("rpa_decode_aligned", "rpa_decode_stream_aligned",
                            "rpa_extend_aligned"),
                "merged": ("rpa_decode_merged", None, "rpa_extend_merged"),
                "chunked": ("rpa_decode", "rpa_decode_stream", "rpa_extend"),
                "aligned256": ("rpa_decode_aligned_256", "rpa_decode_stream_aligned_256",
                               "rpa_extend_aligned_256")}


def _group_fns(pool, kind, hkv, head_dim, meta):
    """The wrapper and the plain version of ``kind`` on ``pool``'s build."""
    chunked = dict(num_kv_heads=hkv, head_dim=head_dim) if pool == "chunked" else {}
    if kind == "extend":
        if chunked:
            return (functools.partial(rpa.ragged_paged_attention_chunked_extend, meta=meta,
                                      **chunked),
                    functools.partial(rpa.extend_attention_plain, meta=meta, **chunked))
        return (functools.partial(rpa.ragged_paged_attention_extend, meta=meta),
                functools.partial(rpa.ragged_paged_attention_extend_plain, meta=meta))
    if chunked:
        fn = (rpa_packed.ragged_paged_attention_chunked_packed if kind == "decode"
              else rpa_stream.ragged_paged_attention_chunked_stream)
        return (functools.partial(fn, **chunked),
                functools.partial(rpa_packed.decode_attention_plain, **chunked))
    fn = (rpa_packed.ragged_paged_attention_packed if kind == "decode"
          else rpa_stream.ragged_paged_attention_stream)
    return fn, rpa_packed.ragged_paged_attention_packed_plain


@pytest.mark.parametrize("kv", ["bfloat16", "fp8_e4m3"])
@pytest.mark.parametrize("kind", ["decode", "stream", "extend"])
@pytest.mark.parametrize("pool,extra,hq,hkv,head_dim", GROUP_CASES,
                         ids=[f"{p}-{q}x{k}" for p, _, q, k, _ in GROUP_CASES])
def test_gqa_kernels_past_sixteen_heads_per_kv_head(cuda_device, pool, extra, hq, hkv,
                                                   head_dim, kind, kv):
    """The GQA decodes and streams in head groups of at most 16 query heads
    (G 48, 71, 17, 20: three, five, two and two groups a KV head), and the
    extends' packed rows m = r G + g at those G (at 71 a 128-row block
    holds less than two query rows), bf16 q over bf16 and e4m3 KV, every
    dead slot NaN, against their plain versions: one launch, zeros on
    kv_len-0 rows; the decode bitwise on a second call. The merged pool
    has no stream (its routing decodes packed)."""
    build = GROUP_BUILDS[pool][("decode", "stream", "extend").index(kind)]
    if build is None:
        pytest.skip("the merged family has no streaming decode (the JAX routing's)")
    dt = torch.bfloat16
    case = _extend_case if kind == "extend" else _decode_case
    q, kv_t, pt, kvl, meta = case(cuda_device, dt, hq=hq, hkv=hkv,
                                  kv_dtype=FP8.get(kv, dt), **extra)
    _poison_dead_slots(kv_t, pt, kvl, 1)
    fn, plain = _group_fns(pool, kind, hkv, head_dim, meta)
    kw = dict(page_size=PS, scale=head_dim ** -0.5)
    k = KERNELS[build]
    before = k.launches
    out = fn(q, kv_t, 1, pt, kvl, **kw)
    ref = plain(q, kv_t, 1, pt, kvl, **kw)
    torch.cuda.synchronize()
    assert k.launches == before + 1
    assert out.shape == q.shape and torch.isfinite(out).all()
    if kind != "extend":
        assert not out[kvl == 0].any()
        assert torch.equal(fn(q, kv_t, 1, pt, kvl, **kw), out)
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("kind", ["decode", "stream"])
@pytest.mark.parametrize("pool,extra,hq,hkv,head_dim", GROUP_CASES[:3],
                         ids=[f"{p}-{q}x{k}" for p, _, q, k, _ in GROUP_CASES[:3]])
def test_head_groups_split_and_stream_long_kv(cuda_device, pool, extra, hq, hkv, head_dim,
                                              kind):
    """At StarCoder's and Falcon-7B's head groups over 16 requests of
    2048-4096 positions: the packed decode's plan splits each request over
    blocks (the combine pass merging every group's rows), the stream cuts
    requests across warps and blocks (its combine pass over every group's
    scratch rows); against the plain version, bitwise on a second call,
    with a window crossing the splits on the decode."""
    build = GROUP_BUILDS[pool][0 if kind == "decode" else 1]
    if build is None:
        pytest.skip("the merged family has no streaming decode (the JAX routing's)")
    lens = np.random.default_rng(3).integers(2048, 4097, size=16)
    lens[0], lens[-1] = 4096, 0
    q, kv_t, pt, kvl, meta = _case(5, [1] * 16, lens.tolist(), cuda_device, torch.bfloat16,
                                   hq=hq, hkv=hkv, **extra)
    groups = rpa_packed.head_groups(KERNELS[build], hq, hkv)
    assert groups == hkv * -(-(hq // hkv) // 16) and groups > hkv
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    if kind == "decode":
        assert rpa_packed.decode_split_plan(build, 16, groups, pt.shape[1] * PS, sms)[0] > 1
    fn, plain = _group_fns(pool, kind, hkv, head_dim, meta)
    kw = dict(page_size=PS, scale=head_dim ** -0.5)
    if kind == "decode":
        kw["sliding_window"] = 1000
    k = KERNELS[build]
    before = k.launches
    out = fn(q, kv_t, 1, pt, kvl, **kw)
    again = fn(q, kv_t, 1, pt, kvl, **kw)
    ref = plain(q, kv_t, 1, pt, kvl, **kw)
    torch.cuda.synchronize()
    assert k.launches == before + 2
    assert torch.equal(out, again) and not out[kvl == 0].any()
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("kind", ["decode", "extend"])
@pytest.mark.parametrize("hq,hkv", [(36, 4), (12, 2), (48, 1)], ids=["g9", "g6", "g48"])
def test_aligned_kernels_with_a_window_at_new_head_groups(cuda_device, hq, hkv, kind):
    """StarCoder2-7B's G = 9 with its sliding window, G = 6 and StarCoder's
    48: the aligned decode and extend with a window of 24 that cuts every
    long request (an extend row m = r G + g of a query row r whose 16-row
    warp tile holds two query rows at G = 9 and 6), bf16, every dead slot
    NaN, against their plain versions."""
    case = _extend_case if kind == "extend" else _decode_case
    q, kv_t, pt, kvl, meta = case(cuda_device, torch.bfloat16, aligned=True, hq=hq, hkv=hkv)
    _poison_dead_slots(kv_t, pt, kvl, 1)
    fn, plain = _group_fns("aligned", kind, hkv, D_ALIGNED, meta)
    kw = _opts("window", D_ALIGNED ** -0.5)
    out = fn(q, kv_t, 1, pt, kvl, **kw)
    ref = plain(q, kv_t, 1, pt, kvl, **kw)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1e-2)


def test_alibi_decode_past_sixteen_heads_per_kv_head(cuda_device):
    """The aligned decode's ALiBi instantiation at G = 17 (34 / 2): each
    group's rows read their own heads' slopes."""
    q, kv_t, pt, kvl, _ = _decode_case(cuda_device, torch.bfloat16, aligned=True, hq=34,
                                       hkv=2)
    kw = dict(page_size=PS, scale=D_ALIGNED ** -0.5, alibi_slopes=_alibi(34, cuda_device))
    out = rpa_packed.ragged_paged_attention_packed(q, kv_t, 1, pt, kvl, **kw)
    ref = rpa_packed.ragged_paged_attention_packed_plain(q, kv_t, 1, pt, kvl, **kw)
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1e-2)


def test_float32_decode_past_sixteen_heads_is_refused(cuda_device):
    """float32 q at StarCoder's G = 48 (6144 outputs a block) and Falcon's
    71 at 64 (4544) is past the float32 decodes' 1024: refused naming
    ROADMAP B9.7."""
    for extra, hq in (({"aligned": True}, 48), ({"merged": True}, 71)):
        q, kv_t, pt, kvl, _ = _decode_case(cuda_device, torch.float32, hq=hq, hkv=1, **extra)
        with pytest.raises(NotImplementedError, match="ROADMAP B9.7"):
            rpa_packed.ragged_paged_attention_packed(q, kv_t, 1, pt, kvl, page_size=PS,
                                                     scale=0.1)


# one small config per class of the LayerNorm families (float32), and the
# two kernels each runs on the card: GPT-BigCode multi-query (8 / 1) and
# Falcon over one KV head at 64 (16 / 1, the merged pool), StableLM on the
# chunked pool, GPT-2 and Phi on the merged one. float32 decodes hold G x
# head_dim <= 1024 (B9.7): the head groups past 16 run in bf16, in the
# kernel tests above and in chip_smoke.py's StarCoder and Falcon-7B serves
LN_ENGINES = {
    "stablelm": (_family_cfg("StableLmForCausalLM", head_dim=64, num_attention_heads=8,
                             num_key_value_heads=8, use_qkv_bias=True,
                             partial_rotary_factor=0.25), ("rpa_decode", "rpa_extend")),
    "starcoder2": (_family_cfg("Starcoder2ForCausalLM", num_key_value_heads=2,
                               hidden_act="gelu_pytorch_tanh", sliding_window=24),
                   ("rpa_decode_aligned", "rpa_extend_aligned")),
    "phi": (_family_cfg("PhiForCausalLM", head_dim=64, partial_rotary_factor=0.5),
            ("rpa_decode_merged", "rpa_extend_merged")),
    "cohere": (_family_cfg("CohereForCausalLM", num_key_value_heads=2, logit_scale=0.25),
               ("rpa_decode_aligned", "rpa_extend_aligned")),
    "olmo2": (_family_cfg("Olmo2ForCausalLM"), ("rpa_decode_aligned", "rpa_extend_aligned")),
    "phi3small": (_family_cfg("Phi3SmallForCausalLM", num_key_value_heads=2,
                              hidden_act="gegelu", mup_use_scaling=True,
                              mup_attn_multiplier=1.0, mup_embedding_multiplier=10.0,
                              mup_width_multiplier=8.0, gegelu_limit=0.05,
                              dummy_token_indices=[3, 100]),
                  ("rpa_decode_aligned", "rpa_extend_aligned")),
    "gpt2": (_family_cfg("GPT2LMHeadModel", head_dim=64, max_position_embeddings=512),
             ("rpa_decode_merged", "rpa_extend_merged")),
    "gpt_bigcode": (_family_cfg("GPTBigCodeForCausalLM", num_attention_heads=8,
                                num_key_value_heads=1, max_position_embeddings=512,
                                activation_function="gelu"),
                    ("rpa_decode_aligned", "rpa_extend_aligned")),
    "olmo": (_family_cfg("OlmoForCausalLM", clip_qkv=0.1),
             ("rpa_decode_aligned", "rpa_extend_aligned")),
    "falcon": (_family_cfg("FalconForCausalLM", head_dim=64, num_attention_heads=16,
                           num_key_value_heads=1), ("rpa_decode_merged", "rpa_extend_merged")),
    "dbrx": (_family_cfg("DbrxForCausalLM", num_key_value_heads=2, num_experts=4,
                         num_experts_per_tok=2, moe_intermediate_size=64,
                         norm_topk_prob=True, clip_qkv=0.1),
             ("rpa_decode_aligned", "rpa_extend_aligned")),
}


@pytest.mark.parametrize("family", list(LN_ENGINES))
def test_engine_layernorm_families_on_cuda_match_cpu(cuda_device, family):
    """Each class of the LayerNorm families in float32 on the card gives the
    CPU Engine's greedy tokens through its pool's two kernels alone: the
    LayerNorms, parallel blocks, learned positions, clips, muP scalings and
    logit bias around them, multi-query attention on the aligned and the
    merged pool."""
    cfg, kernels = LN_ENGINES[family]
    _engines_agree(cuda_device, cfg, list(kernels))


# ------------------------------------------------ rounds replayed from graphs
# (model config, ServerArgs fields, the target's extend, the draft pool's
# decode and extend): a small target (the first) and the pool geometry of
# each full-width speculating path, one layer deep, in bf16
ROUND_PATHS = {
    "llama_small": (dict(_llama_cfg(D, num_kv_heads=8), dtype="bfloat16"), {},
                    "rpa_extend", "rpa_decode_merged", "rpa_extend_merged"),
    # the 1B-class model's pools: Hq 32, Hkv 8, head_dim 64
    "llama_1b_pools": (dict(_llama_cfg(D, num_kv_heads=8), num_attention_heads=32,
                            hidden_size=2048, num_hidden_layers=1, dtype="bfloat16"), {},
                       "rpa_extend", "rpa_decode_merged", "rpa_extend_merged"),
    # Meta-Llama-3-8B's: Hq 32, Hkv 8, head_dim 128, fp8_e4m3 KV
    "llama3_8b_pools": (dict(_llama_cfg(D_ALIGNED, num_kv_heads=8), num_attention_heads=32,
                             hidden_size=4096, num_hidden_layers=1, dtype="bfloat16"),
                        {"kv_cache_dtype": "fp8_e4m3"},
                        "rpa_extend_aligned", "rpa_decode_aligned", "rpa_extend_aligned"),
    # DeepSeek-V2-Lite's latent row (576, Hq 16) under NextN, MoE
    "deepseek_latent": (_deepseek_cfg("bfloat16"), {},
                        "rpa_extend_mla", "rpa_decode_mla", "rpa_extend_mla"),
    # MiniCPM3-4B's (288, Hq 40) under NextN
    "minicpm3_latent288": (_minicpm3_cfg("bfloat16"), {},
                           "rpa_extend_mla_288", "rpa_decode_mla_288", "rpa_extend_mla_288"),
    # Gemma-2-9B's: Hq 16, Hkv 8, head_dim 256, softcaps, a window
    "gemma2_256": (dict(_gemma2_cfg(), num_attention_heads=16, num_key_value_heads=8,
                        num_hidden_layers=2, dtype="bfloat16"), {},
                   "rpa_extend_aligned_256", "rpa_decode_aligned_256",
                   "rpa_extend_aligned_256"),
}
ROUND_CASES = ([("llama_small", k) for k in ("chain", "tree", "ngram")]
               + [(p, k) for p in sorted(ROUND_PATHS) if p != "llama_small"
                  for k in ("chain", "tree")])


def _round_engine(path):
    """A speculating Engine on the card (EAGLE, or NextN on a DeepSeek
    target; the (4, 2, 1, 1) tree, 4 draft tokens) on predictive weights:
    the target's final norm the identity and its embedding x 4, the
    draft's fc (NextN: eh_proj, its norms ones) passing the token
    embedding, so that drafts are accepted."""
    cfg, extra = ROUND_PATHS[path][:2]
    eng = Engine(ServerArgs(random_weights=True, page_size=PS, max_total_tokens=8192,
                            chunked_prefill_size=64, speculative_algorithm="EAGLE",
                            speculative_num_draft_tokens=4, speculative_eagle_topk=4, **extra),
                 ModelConfig(**cfg))
    runner = eng.runner
    assert runner.round_graphs is not None
    H = cfg["hidden_size"]
    gemma = cfg["architecture"] == "Gemma2ForCausalLM"
    with torch.no_grad():
        runner.model.leaf("final_norm").fill_(0.0 if gemma else 1.0)
        runner.model.leaf("embed.w").mul_(4.0)
        nextn = cfg["architecture"] != "LlamaForCausalLM" and not gemma
        fc = runner.draft_model.leaf("eh_proj.w" if nextn else "fc.w")
        fc[H:] *= 0.01
        fc[:H] = torch.eye(H, dtype=fc.dtype, device=fc.device)
        if nextn:
            for k in ("enorm", "hnorm", "head_norm"):
                runner.draft_model.leaf(k).fill_(1.0)
    runner.set_spec_thresholds()
    return eng


def _round_call(eng, kind, lens, seed):
    """Pools refilled, requests of ``lens`` committed positions on pages
    from the allocator, and a function running the round of ``kind`` over
    them through the runner's host form (NGRAM: drafts of 0-4 tokens, the
    last token repeated for every other request), the number of requests
    (the rows past it pad the batch bucket), and a function running the
    eager round's body over the same batch already on the card."""
    from semi_pd_tpu_torch.runtime import batch as port_batch
    from semi_pd_tpu_torch.runtime.req import Req

    runner, s = eng.runner, eng.scheduler
    dev = runner.device
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    for buf in (runner.kv_cache.buffer, runner.draft_kv.buffer):
        buf.copy_((torch.randn(buf.shape, generator=g, device=dev) * 0.1).to(buf.dtype))
    rng = np.random.default_rng(seed)
    vocab = runner.model_config.vocab_size
    reqs = []
    for i, n in enumerate(lens):
        r = Req(rid=f"r{seed}-{i}", input_ids=rng.integers(0, vocab, size=int(n)).tolist(),
                sampling_params=SamplingParams(temperature=0.0))
        r.req_slot = runner.req_pool.alloc()
        pages = runner.page_allocator.alloc(-(-(int(n) + 32) // PS))
        r.pages = pages.tolist()
        runner.req_pool.write(r.req_slot, 0, pages)
        r.prefilled_len = r.prompt_len
        r.output_ids.append(int(rng.integers(0, vocab)))
        reqs.append(r)
    table, gamma = runner.req_pool.page_table, s.spec_gamma
    if kind == "tree":
        hb = port_batch.build_tree_verify_batch(reqs, runner.tree_template, table, PS,
                                                s.b_buckets, s.p_buckets)
    else:
        drafts = [[0] * gamma] * len(reqs)
        if kind == "ngram":
            drafts = [[r.output_ids[-1]] * int(rng.integers(0, gamma + 1)) if i % 2 == 0
                      else rng.integers(0, vocab, size=int(rng.integers(0, gamma + 1))).tolist()
                      for i, r in enumerate(reqs)]
        hb, dp, dl = port_batch.build_spec_verify_batch(reqs, drafts, gamma, table, PS,
                                                        s.b_buckets, s.p_buckets)
    prev = rng.normal(size=(hb.B, runner.model_config.hidden_size)).astype(np.float32)
    call = {"chain": lambda: runner.eagle_step_host(hb, prev, gamma),
            "tree": lambda: runner.eagle_tree_step_host(hb, prev),
            "ngram": lambda: runner.spec_step_host(hb, dp, dl, gamma)}[kind]
    if kind == "ngram":
        extra = (None, torch.as_tensor(dp, device=dev), torch.as_tensor(dl, device=dev))
    else:
        extra = (torch.as_tensor(prev, device=dev), None, None)
    spec = runner.tree_template.branching if kind == "tree" else gamma
    fb = hb.to_device(dev)
    # the eager round over tensors already on the card (the body a graph
    # captures: speculative/eagle.py's rounds, or NGRAM's verify)
    body = lambda: runner._round_body(runner._round_shape(kind, fb, spec), fb, *extra)
    return call, len(reqs), body


def _live(pool):
    """The bytes of the pool but its dump page (slots 0 to PS - 1), where
    the padded rows' scatter to one slot has no defined winner on the
    card."""
    live = pool[:, PS:] if pool.dim() == 4 else pool[:, :, PS:]
    return live.contiguous().view(torch.uint8)


def _bits(t):
    return t.contiguous().view(torch.uint8)


@pytest.mark.parametrize("path,kind", ROUND_CASES)
def test_round_graph_replays_the_eager_round_bitwise(cuda_device, path, kind):
    """A round replayed from its graph gives the eager round's accept
    lengths, next tokens, tokens and hidden states bitwise and leaves both
    pools as it does, on two batches of one key (other lengths, pages,
    pool contents; the requests' rows: a padding row's draft steps read
    the dump page, which every padding row writes at one slot with no
    defined winner, and its results are dropped); the second does not
    capture; EAGLE's and NextN's drafts are accepted; a replay counts the
    launches its capture recorded, the path's builds only: the target's
    extend L times a verify, the draft pool's decode once a chain draft or
    refresh step, its extend once a tree level; neither a replay nor the
    eager round over tensors on the card (speculative/eagle.py's rounds,
    NGRAM's verify) syncs with the host."""
    eng = _round_engine(path)
    runner = eng.runner
    ext, dec, dext = ROUND_PATHS[path][2:]
    L, tree = runner.model_config.num_hidden_layers, runner.tree_template
    want_tally = {"chain": {ext: L, dec: 2 * 4}, "ngram": {ext: L},
                  "tree": {ext: L, dec: tree.depth}}[kind]
    if kind == "tree":
        want_tally[dext] = want_tally.get(dext, 0) + len(tree.level_nodes)
    accepted = 0
    for seed, lens in ((1, [33, 260, 9, 77, 140]), (2, [300, 17, 64, 2, 199, 80])):
        call, n, body = _round_call(eng, kind, lens, seed)
        pools = [runner.kv_cache.buffer, runner.draft_kv.buffer]
        start = [p.clone() for p in pools]
        graphs, runner.round_graphs = runner.round_graphs, None
        try:
            want = call()
        finally:
            runner.round_graphs = graphs
        want_pools = [_live(p).clone() for p in pools]
        for p, s0 in zip(pools, start):
            p.copy_(s0)
        for k in KERNELS.values():
            k.launches = 0
        got = call()
        torch.cuda.synchronize()
        assert {n: k.launches for n, k in KERNELS.items() if k.launches} == want_tally
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(_bits(a[:n]), _bits(b[:n]))
        for p, w in zip(pools, want_pools):
            assert torch.equal(_live(p), w)
        if kind != "ngram":
            assert torch.isfinite(got[3][:n].float()).all()
        accepted += int(got[0][:n].sum())
    (key, g), = runner.round_graphs.graphs.items()
    assert key.kind == kind and g.tally == want_tally
    # the rounds' accepted paths ran (NGRAM's random pools reject its drafts
    # at bf16; acceptance is a value there, not a path)
    assert accepted > 0 or kind == "ngram"
    assert runner.round_graphs.stats["captures"] == 1 and runner.round_graphs.pool_bytes() > 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        call()
        body()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_spec_engine_serves_the_same_tokens_on_round_graphs_and_eagerly(cuda_device):
    """The speculating Engine on round graphs (the default) and with
    decode_graphs=False give the same greedy tokens and accepted drafts,
    every round replayed, on the 1B-class pools with the tree."""
    cfg, _ = ROUND_PATHS["llama_1b_pools"][:2]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, size=n).tolist() for n in (20, 100, 37, 250)]
    sp = SamplingParams(max_new_tokens=24, temperature=0.0, ignore_eos=True)
    outs = []
    for graphs in (True, False):
        eng = _round_engine("llama_1b_pools")
        if not graphs:
            eng.runner.round_graphs = eng.runner.graphs = None
        outs.append(([o["output_ids"] for o in eng.generate(input_ids=prompts,
                                                             sampling_params=sp)],
                     eng.scheduler.n_spec_accepted))
        if graphs:
            rg = eng.runner.round_graphs
            assert rg.stats["replays"] == eng.runner.spec_counts["verify"] > 0
    assert outs[0] == outs[1] and outs[0][1] > 0


def test_a_failed_round_capture_raises(cuda_device, monkeypatch):
    """A round whose body syncs with the host cannot be captured: the round
    raises and keeps no graph, and nothing runs it eagerly in its place.
    (Last in this file: a failed capture leaves nothing behind, but no
    later test depends on that.)"""
    eng = _round_engine("llama_small")
    runner = eng.runner
    body = runner._round_body
    calls = []

    def syncing(shape, fb, *args):
        calls.append(shape)
        int(fb.kv_lens.sum())  # a device->host read
        return body(shape, fb, *args)

    monkeypatch.setattr(runner, "_round_body", syncing)
    call = _round_call(eng, "chain", [33, 260, 9], 3)[0]
    with pytest.raises(RuntimeError):
        call()
    torch.cuda.synchronize()
    assert not runner.round_graphs.graphs and runner.round_graphs.stats["replays"] == 0
    assert len(calls) == 2  # the warm-up and the capture; no eager round after


# ---------------------------------- the image path and the classifiers' heads
@pytest.mark.parametrize("kv", ["bfloat16", "fp8_e4m3"])
@pytest.mark.parametrize("kind", ["decode", "stream", "extend"])
def test_gqa_builds_at_seven_heads_per_kv_head(cuda_device, kind, kv):
    """Qwen2-VL-7B's 28 / 4 (G = 7: a KV head's 7 query heads in one m16
    tile of the decodes, an extend row m = r * 7 + g cut across the 16-row
    warp tiles) through the aligned builds, bf16 q over bf16 and e4m3 KV,
    every dead slot NaN, against their plain versions: one launch, zeros
    on kv_len-0 rows."""
    dt = torch.bfloat16
    case = _extend_case if kind == "extend" else _decode_case
    q, pool, pt, kvl, meta = case(cuda_device, dt, aligned=True, hq=28, hkv=4,
                                  kv_dtype=FP8.get(kv, dt))
    _poison_dead_slots(pool, pt, kvl, 1)
    fn, plain = _group_fns("aligned", kind, 4, D_ALIGNED, meta)
    kw = dict(page_size=PS, scale=D_ALIGNED ** -0.5)
    k = KERNELS[GQA_BUILDS[kind]]
    before = k.launches
    out = fn(q, pool, 1, pt, kvl, **kw)
    ref = plain(q, pool, 1, pt, kvl, **kw)
    torch.cuda.synchronize()
    assert k.launches == before + 1
    assert torch.isfinite(out).all()
    if kind != "extend":
        assert not out[kvl == 0].any()
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("kv", ["bfloat16", "fp8_e4m3"])
@pytest.mark.parametrize("opt", ["softcap", "softcap_window"])
@pytest.mark.parametrize("kind", ["decode", "extend"])
def test_gemma2_at_head_dim_128_on_the_aligned_builds(cuda_device, kind, opt, kv):
    """Skywork-Reward-Gemma-2-27B's 32 / 16 heads at head_dim 128 (Gemma-2
    had run on the _256 builds alone): the aligned decode and extend with
    softcap 50, and with a window of 24 that cuts the long requests,
    scale 144 ** -0.5, bf16 q over bf16 and e4m3 KV, every dead slot NaN,
    against their plain versions."""
    dt = torch.bfloat16
    case = _extend_case if kind == "extend" else _decode_case
    q, pool, pt, kvl, meta = case(cuda_device, dt, aligned=True, hq=32, hkv=16,
                                  kv_dtype=FP8.get(kv, dt))
    _poison_dead_slots(pool, pt, kvl, 1)
    fn, plain = _group_fns("aligned", kind, 16, D_ALIGNED, meta)
    kw = dict(page_size=PS, scale=144 ** -0.5, logit_cap=50.0,
              sliding_window=24 if opt == "softcap_window" else None)
    out = fn(q, pool, 1, pt, kvl, **kw)
    ref = plain(q, pool, 1, pt, kvl, **kw)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1e-2)


def _vlm_hf(arch):
    """A tiny vision-language config.json dict (float32 tests): a 2-layer
    text model at head_dim 128 (G = 2; Qwen2-VL's G = 7: 14 / 2), a 2-layer
    tower."""
    text = dict(architectures=["LlamaForCausalLM"], hidden_size=256, intermediate_size=512,
                num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                head_dim=128, vocab_size=512, max_position_embeddings=512, rms_norm_eps=1e-5)
    if arch == "llava":
        return dict(architectures=["LlavaForConditionalGeneration"], image_token_index=500,
                    text_config=text, vision_feature_layer=-2,
                    vision_config=dict(hidden_size=64, image_size=56, intermediate_size=128,
                                       num_attention_heads=4, num_hidden_layers=2,
                                       patch_size=14))
    return dict(dict(text, num_attention_heads=14, num_key_value_heads=2),
                architectures=["Qwen2VLForConditionalGeneration"], image_token_id=500,
                rope_theta=1e6, rope_scaling={"type": "mrope", "mrope_section": [16, 24, 24]},
                vision_config=dict(depth=2, embed_dim=32, mlp_ratio=2, num_heads=2, in_chans=3,
                                   hidden_size=256, patch_size=14, spatial_merge_size=2,
                                   temporal_patch_size=2))


def _lift_vlm(model):
    """Norm weights of the text model and the tower at 1 (the image reaches
    the tokens)."""
    with torch.no_grad():
        for path, _ in model.param_specs():
            keys = path.split(".")
            name = keys[-2] if keys[-1] in ("w", "b") else keys[-1]
            if ("norm" in name or name in ("pre_ln", "ln1", "ln2", "ln_q")) and keys[-1] != "b":
                model.leaf(path).fill_(1.0)


@pytest.mark.parametrize("arch", ["llava", "qwen2vl"])
def test_engine_vlm_on_cuda_matches_cpu(cuda_device, arch):
    """A tiny LLaVA and Qwen2-VL (float32) on the card serve image prompts
    (an image across a 64-token chunk boundary, two images in one prompt)
    with the CPU Engine's greedy tokens on the same parameters, through the
    aligned decode and extend alone (the towers are plain torch ops)."""
    serve = dict(random_weights=True, page_size=PS, max_total_tokens=4096,
                 chunked_prefill_size=64, enable_semi_pd=True)
    cfg = lambda: ModelConfig.from_hf_config(_vlm_hf(arch), dtype="float32")
    gpu = Engine(ServerArgs(**serve), cfg())
    _lift_vlm(gpu.runner.model)
    cpu = Engine(ServerArgs(device="cpu", **serve), cfg(), device="cpu")
    cpu.runner.model.load_jax_params(gpu.runner.model.params_tree())
    rng = np.random.default_rng(0)
    size = (3, 56, 56) if arch == "llava" else (3, 56, 84)
    img = lambda: rng.standard_normal(size, dtype=np.float32)
    prompts = [list(range(3, 60)) + [500, 7, 8], [5, 500, 6, 500, 9], [9, 500, 11]]
    images = [img(), [img(), img()], img()]
    sp = SamplingParams(max_new_tokens=6, temperature=0.0, ignore_eos=True)
    for k in KERNELS.values():
        k.launches = 0
    got = gpu.generate(input_ids=prompts, image_data=images, sampling_params=sp)
    assert {n for n, k in KERNELS.items() if k.launches} == {"rpa_decode_aligned",
                                                             "rpa_extend_aligned"}
    want = cpu.generate(input_ids=prompts, image_data=images, sampling_params=sp)
    assert [o["output_ids"] for o in got] == [o["output_ids"] for o in want]
    assert gpu.flush_cache() and cpu.flush_cache()


def test_mrope_decode_graph_replays_the_shifted_position_bitwise(cuda_device):
    """A bf16 Qwen2-VL decode step whose requests' rope positions are
    shifted (kv_len - 1 + mrope_delta, as their images shift them) while
    the kernels read kv_len: the replay gives the eager step's tokens and
    log-probs bitwise, one capture, and the same step at the unshifted
    position gives other log-probs (the shift reaches the rope)."""
    from semi_pd_tpu_torch.runtime.batch import build_decode_batch
    from semi_pd_tpu_torch.runtime.req import Req

    cfg = ModelConfig.from_hf_config(_vlm_hf("qwen2vl"), dtype="bfloat16")
    eng = Engine(ServerArgs(random_weights=True, page_size=PS, max_total_tokens=4096,
                            chunked_prefill_size=64), cfg)
    runner, sched = eng.runner, eng.scheduler
    assert runner.mrope
    _fill_pool(eng, cuda_device, seed=0)
    rng = np.random.default_rng(1)
    reqs = []
    for i, n in enumerate([33, 260, 9, 77, 1, 140]):
        r = Req(rid=f"m{i}", input_ids=[1] * n, sampling_params=SamplingParams(temperature=0.0))
        r.req_slot = runner.req_pool.alloc()
        pages = runner.page_allocator.alloc(-(-(n + 1) // PS))
        r.pages = pages.tolist()
        runner.req_pool.write(r.req_slot, 0, pages)
        r.prefilled_len = n
        r.output_ids.append(int(rng.integers(0, 512)))
        r.mrope_pos = np.zeros((n, 3), np.int32)
        r.mrope_delta = -int(rng.integers(1, 200))
        reqs.append(r)
    hb = build_decode_batch(reqs, runner.req_pool.page_table, PS, sched.b_buckets,
                            sched.p_buckets)
    shifted = hb.pack(mrope=True)
    hb.mrope_pos = None
    plain_rope = hb.pack(mrope=True)
    want = _eager_step(runner, *shifted, is_decode=True)
    got = runner.step_packed_raw(*shifted, is_decode=True)
    again = runner.step_packed_raw(*shifted, is_decode=True)
    other = _eager_step(runner, *plain_rope, is_decode=True)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(again[1], want[1])
    assert runner.graphs.stats["captures"] == 1
    assert not torch.equal(other[1], want[1])


# ------------------------------------------------------------- quantized weights
def _quant_leaves(dev, method, K, N, E=None, seed=0):
    from semi_pd_tpu_torch.model_loader.quantize import _quant_one

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    shape = (K, N) if E is None else (E, K, N)
    w = (0.02 * torch.randn(shape, generator=g, device=dev)).to(torch.bfloat16)
    return dict(zip(("w", "ws", "wz"), _quant_one(w, method)))


# (method, K, N): the served tails (V2-Lite's kv_a N = 576, its dense down
# K = 10944: blockwise part blocks; a decode-sized down splits K over
# blocks) and shapes off 16 bytes, which take the element-wise tile loads
WO_CASES = [("fp8", 4096, 576), ("fp8", 10944, 2048), ("fp8", 200, 300), ("int8", 2048, 576),
            ("int8", 136, 260), ("blockwise_fp8", 2048, 576), ("blockwise_fp8", 10944, 2048),
            ("blockwise_fp8", 200, 300), ("awq_int4", 1024, 576), ("awq_int4", 200, 300),
            ("awq_int4", 8192, 1024)]
WO_NAME = {"fp8": "wo_gemm", "int8": "wo_gemm", "blockwise_fp8": "wo_gemm_block",
           "awq_int4": "wo_gemm_awq"}


@pytest.mark.parametrize("T", [1, 37, 130])
@pytest.mark.parametrize("method,K,N", WO_CASES, ids=[f"{m}-{k}x{n}" for m, k, n in WO_CASES])
def test_wo_gemm_kernels_match_plain(cuda_device, method, K, N, T):
    """Each dense weight-only dequant kernel launches (one count) and gives
    its plain version's output within 1e-2 of the output's scale (bf16
    out; the float32 sums run in another order), at every tail of T, K and
    N; a second run gives the same bits (split K sums its partials in a
    fixed order)."""
    from semi_pd_tpu_torch.ops.quant import wo_gemm

    p = _quant_leaves(cuda_device, method, K, N, seed=K + N)
    g = torch.Generator(device=cuda_device)
    g.manual_seed(T)
    x = torch.randn((T, K), generator=g, device=cuda_device).to(torch.bfloat16)
    k = KERNELS[WO_NAME[method]]
    before = k.launches
    out = wo_gemm.quant_matmul(x, p)
    again = wo_gemm.quant_matmul(x, p)
    torch.cuda.synchronize()
    assert k.launches == before + 2
    ref = wo_gemm.quant_matmul_plain(x, p).float()
    assert out.dtype == torch.bfloat16 and out.shape == (T, N)
    assert torch.isfinite(out).all()
    assert float((out.float() - ref).abs().max()) <= 1e-2 * float(ref.abs().max())
    assert torch.equal(out, again)


@pytest.mark.parametrize("method", ["fp8", "int8"])
@pytest.mark.parametrize("K,N", [(2048, 2816), (200, 300)])
def test_wo_gemm_experts_matches_plain(cuda_device, method, K, N):
    """The quantized expert stack's grouped product over rows sorted by
    expert (8 experts, some groups empty, ragged ones up to 150 rows)
    against the stack dequantized to bf16 and the plain loop: within 1e-2
    of the output's scale, one launch, no host read of the groups."""
    from semi_pd_tpu_torch.ops.quant import wo_gemm

    E = 8
    p = _quant_leaves(cuda_device, method, K, N, E=E, seed=3)
    sizes = torch.tensor([5, 0, 150, 1, 0, 64, 17, 0], device=cuda_device)
    g = torch.Generator(device=cuda_device)
    g.manual_seed(1)
    x = torch.randn((int(sizes.sum()), K), generator=g, device=cuda_device).to(torch.bfloat16)
    k = KERNELS["wo_gemm_experts"]
    before = k.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = wo_gemm.wo_gemm_experts(x, p["w"], p["ws"], sizes)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert k.launches == before + 1
    ref = wo_gemm.wo_gemm_experts_plain(x, p["w"], p["ws"], sizes).float()
    assert float((out.float() - ref).abs().max()) <= 1e-2 * float(ref.abs().max())


def test_wo_gemm_refuses_float32_and_e5m2(cuda_device):
    """On the card the kernels take bf16 activations and e4m3 / int8
    weights: float32 activations, e5m2 weights and a float32 model with
    quantized weights raise NotImplementedError naming ROADMAP B9.8, and
    nothing falls back to the plain version."""
    from semi_pd_tpu_torch.ops.quant import wo_gemm

    p = _quant_leaves(cuda_device, "fp8", 256, 256)
    x = torch.randn((4, 256), device=cuda_device)
    with pytest.raises(NotImplementedError, match="B9.8"):
        wo_gemm.wo_gemm(x, p["w"], p["ws"])
    with pytest.raises(NotImplementedError, match="B9.8"):
        wo_gemm.wo_gemm(x.to(torch.bfloat16), p["w"].float().to(torch.float8_e5m2), p["ws"])
    with pytest.raises(NotImplementedError, match="B9.8"):
        Engine(ServerArgs(random_weights=True, page_size=PS, max_total_tokens=4096,
                          quantization="fp8"), ModelConfig(**_family_cfg("LlamaForCausalLM")))


QUANT_GRAPHS = {
    "llama-fp8": (_family_cfg("LlamaForCausalLM", num_key_value_heads=2), "fp8"),
    "llama-awq_int4": (_family_cfg("LlamaForCausalLM", num_key_value_heads=2), "awq_int4"),
    "qwen2_moe-int8": (_family_cfg("Qwen2MoeForCausalLM", **QWEN2_MOE), "int8"),
    "qwen2_moe-blockwise_fp8": (_family_cfg("Qwen2MoeForCausalLM", **QWEN2_MOE),
                                "blockwise_fp8"),
}


@pytest.mark.parametrize("case", list(QUANT_GRAPHS))
def test_quantized_decode_graph_replays_the_eager_step_bitwise(cuda_device, case):
    """A bf16 model with quantized weights: a replayed decode step gives
    the eager step's tokens and log-probs bitwise; the capture records the
    weight-only dequant kernels' launches (4 dense linears a layer, and a
    MoE layer's shared expert and 2 expert stacks) beside the decode's, and
    neither the eager step nor a replay syncs the host."""
    cfg, method = QUANT_GRAPHS[case]
    cfg = dict(cfg, dtype="bfloat16")
    eng = Engine(ServerArgs(random_weights=True, page_size=PS, max_total_tokens=4096,
                            chunked_prefill_size=64, quantization=method), ModelConfig(**cfg))
    _fill_pool(eng, cuda_device, seed=0)
    runner = eng.runner
    L = cfg["num_hidden_layers"]
    step = _graph_batch(eng, [33, 260, 9, 77, 1, 140], seed=1)
    want = _eager_step(runner, *step, is_decode=True)
    got = runner.step_packed_raw(*step, is_decode=True)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.isfinite(got[1]).all()
    (g,) = runner.graphs.graphs.values()
    want_tally = {"rpa_decode_aligned": L, WO_NAME[method]: 4 * L}
    if "num_experts" in cfg:
        want_tally["wo_gemm_experts"] = 2 * L
    assert g.tally == want_tally
    torch.cuda.set_sync_debug_mode("error")
    try:
        _eager_step(runner, *step, is_decode=True)
        runner.step_packed_raw(*step, is_decode=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
