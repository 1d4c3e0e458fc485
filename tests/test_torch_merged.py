"""The port's 5D pool at head_dim 64 (``[L, 2, S, Hkv, 64]``, the merged
kernels' path, TinyLlama-1.1B's) against the JAX package on the CPU, with
the same numpy inputs:

- the plain decode and extend the merged kernels are held to on the card,
  against the TPU kernel _rpa_kernel_merged in interpret mode
  (``force_merged=True``): GQA, MHA, softcap, a sliding window, shuffled
  pages, q_len > 128 (two work-list entries), float32, bf16 and an
  fp8_e4m3 pool;
- the routing: decode and extend batches on that pool take the merged
  kernels, with or without the streaming decode;
- the Engine's greedy tokens against the JAX Engine at TinyLlama's head
  geometry (Hq 32, Hkv 4, D 64; 2 layers, narrow MLP, small vocab), where
  the layout rule gives the 5D pool, colocated and semi-PD, with float32
  KV, bf16 weights and KV, and fp8_e4m3 KV with per-layer scales.

Kernel geometry: Hq 16, Hkv 2, D 64 (G = 8, as on TinyLlama), page 16.

Tolerances: float32 outputs 2e-5 (both sides in float32: an online softmax
against a full one); bf16 1e-2 (both sides compute in float32 from the same
bf16 inputs and round the output to bf16, whose step is 2^-8 relative);
fp8 pools 2e-5 (float32 queries over the same fp8 bytes, widened exactly);
greedy tokens identical.
"""

import json

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semi_pd_tpu.config.model_config import ModelConfig as JaxModelConfig
from semi_pd_tpu.config.server_args import ServerArgs as JaxServerArgs
from semi_pd_tpu.ops.attention.ragged_paged_attention import (
    ragged_paged_attention as jax_rpa,
)
from semi_pd_tpu.runtime.engine import Engine as JaxEngine
from semi_pd_tpu.runtime.forward_batch import build_attn_meta as jax_meta
from semi_pd_tpu.sampling.sampling_params import SamplingParams as JaxSamplingParams

from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.config.server_args import ServerArgs
from semi_pd_tpu_torch.ops.attention import ragged_paged_attention as rpa
from semi_pd_tpu_torch.ops.attention import rpa_packed
from semi_pd_tpu_torch.ops.attention.rpa_common import check_cuda, kernel_family
from semi_pd_tpu_torch.runtime.engine import Engine
from semi_pd_tpu_torch.runtime.forward_batch import build_attn_meta
from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams

HQ, HKV, D, PS, L = 16, 2, 64, 16, 2
SCALE = D ** -0.5
TOL = {"float32": 2e-5, "bfloat16": 1e-2, "fp8_e4m3": 2e-5}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _setup(seed, q_lens, kv_lens, pad_T=0, pad_B=0, kv="float32", hq=HQ, hkv=HKV):
    """Numpy inputs: a 5D pool [L, 2, S, hkv, 64], queries, a shuffled page
    table and the per-request lengths, with optional bucket padding; the
    queries and the pool for each side in the case's types (bf16: both
    rounded from the same float32 numbers; fp8: the same bytes)."""
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
    pool = rng.normal(size=(L, 2, total * PS, hkv, D)).astype(np.float32)
    T = sum(q_lens) + pad_T
    q = rng.normal(size=(T, hq, D)).astype(np.float32)
    ql = np.zeros(B, np.int64)
    ql[: len(q_lens)] = q_lens
    kl = np.zeros(B, np.int64)
    kl[: len(kv_lens)] = kv_lens
    if kv == "bfloat16":
        jq, jpool = jnp.asarray(q, jnp.bfloat16), jnp.asarray(pool, jnp.bfloat16)
        tq, tpool = _t(q).bfloat16(), _t(pool).bfloat16()
    elif kv == "fp8_e4m3":
        p8 = pool.astype(ml_dtypes.float8_e4m3fn)
        jq, jpool = jnp.asarray(q), jnp.asarray(p8)
        tq, tpool = _t(q), _t(p8.view(np.uint8)).view(torch.float8_e4m3fn)
    else:
        jq, jpool, tq, tpool = jnp.asarray(q), jnp.asarray(pool), _t(q), _t(pool)
    return dict(jq=jq, jpool=jpool, tq=tq, tpool=tpool, pt=pt, q_lens=ql, kv_lens=kl, T=T)


def _jax_merged(d, **kw):
    kvl = d["kv_lens"].astype(np.int32)
    return np.asarray(jax_rpa(
        d["jq"], d["jpool"], 1, jnp.asarray(d["pt"]), jnp.asarray(kvl),
        jax_meta(d["q_lens"], d["kv_lens"], d["T"]), page_size=PS, scale=SCALE,
        interpret=True, force_merged=True, **kw).astype(jnp.float32))


def _port(d, **kw):
    kvl = d["kv_lens"].astype(np.int32)
    meta = build_attn_meta(d["q_lens"], d["kv_lens"], d["T"])
    return rpa.ragged_paged_attention(
        d["tq"], d["tpool"], 1, _t(d["pt"]), _t(kvl), meta, page_size=PS, scale=SCALE,
        **kw).float().numpy()


RAGGED = [33, 5, 0, 64, 17, 160, 9]
DECODE_CASES = {
    # (kv_lens, options, types, (Hq, Hkv))
    "ragged_padded_row": (RAGGED, {}, "float32", (HQ, HKV)),
    "softcap": ([70, 18, 3, 41], {"logit_cap": 5.0}, "float32", (HQ, HKV)),
    "window": ([70, 18, 3, 41], {"sliding_window": 24}, "float32", (HQ, HKV)),
    "mha": ([70, 18, 3, 41], {}, "float32", (2, 2)),
    "bf16": (RAGGED, {}, "bfloat16", (HQ, HKV)),
    "fp8_e4m3": (RAGGED, {}, "fp8_e4m3", (HQ, HKV)),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_merged_decode_plain_matches_jax_merged_kernel(case):
    """The port's decode on the 5D pool at head_dim 64 (plain on the CPU)
    against _rpa_kernel_merged (interpret) on a decode batch."""
    kv_lens, kw, kv, (hq, hkv) = DECODE_CASES[case]
    B = len(kv_lens)
    d = _setup(3, [1] * B, kv_lens, kv=kv, hq=hq, hkv=hkv)
    ref, out = _jax_merged(d, **kw), _port(d, **kw)
    assert out.shape == (B, hq, D)
    live = d["kv_lens"] > 0
    np.testing.assert_allclose(out[live], ref[live], rtol=TOL[kv], atol=TOL[kv])
    assert not out[~live].any(), "rows with kv_len == 0 must be zeros"


EXTEND_CASES = {
    # (q_lens, kv_lens, options, types, (Hq, Hkv)): prefix + new tokens,
    # q_len 140 > 128 spans two work-list entries, a padded batch row and
    # padded token rows
    "multi_block_prefix": ([140, 20, 1, 7], [140, 60, 9, 30], {}, "float32", (HQ, HKV)),
    "softcap": ([40, 130, 7], [90, 130, 57], {"logit_cap": 5.0}, "float32", (HQ, HKV)),
    "window": ([60, 33, 129], [60, 50, 200], {"sliding_window": 24}, "float32", (HQ, HKV)),
    "mha": ([20, 5, 9], [33, 5, 12], {}, "float32", (2, 2)),
    "bf16": ([140, 20, 1, 7], [140, 60, 9, 30], {}, "bfloat16", (HQ, HKV)),
    "fp8_e4m3": ([140, 20, 1, 7], [140, 60, 9, 30], {}, "fp8_e4m3", (HQ, HKV)),
}


@pytest.mark.parametrize("case", sorted(EXTEND_CASES))
def test_merged_extend_plain_matches_jax_merged_kernel(case):
    """The port's extend on the 5D pool at head_dim 64 (plain on the CPU)
    against _rpa_kernel_merged (interpret), with the same work list."""
    q_lens, kv_lens, kw, kv, (hq, hkv) = EXTEND_CASES[case]
    d = _setup(4, q_lens, kv_lens, pad_T=9, pad_B=1, kv=kv, hq=hq, hkv=hkv)
    ref, out = _jax_merged(d, **kw), _port(d, **kw)
    n = sum(q_lens)
    np.testing.assert_allclose(out[:n], ref[:n], rtol=TOL[kv], atol=TOL[kv])
    assert not out[n:].any(), "bucket-padding rows must stay zero"


def test_merged_routing_takes_the_merged_kernels(monkeypatch):
    """On the 5D pool below head_dim 128, T == B and T != B batches go to
    the merged decode and extend kernels (the JAX dispatcher's D % 128 != 0
    branch comes before its packed and stream decode), the streaming decode
    included; head_dim 128 keeps the aligned kernels; head dims with no
    build raise with their ROADMAP item."""
    seen = []

    def record(kernel, q, *a, **k):
        seen.append(kernel.name)
        return q

    monkeypatch.setattr(rpa_packed, "decode_with", record)
    monkeypatch.setattr(rpa, "_extend", record)
    kw = dict(page_size=PS, scale=SCALE)
    dec = _setup(5, [1, 1, 1], [12, 40, 7])
    ext = _setup(5, [5, 9], [12, 40])
    for d, stream in ((dec, False), (dec, True), (ext, False), (ext, True)):
        meta = build_attn_meta(d["q_lens"], d["kv_lens"], d["T"])
        kvl = _t(d["kv_lens"].astype(np.int32))
        rpa.ragged_paged_attention(d["tq"], d["tpool"], 0, _t(d["pt"]), kvl, meta,
                                   stream=stream, **kw)
    assert kernel_family(dec["tpool"]) == "merged"
    assert seen == ["rpa_decode_merged"] * 2 + ["rpa_extend_merged"] * 2
    wide = torch.zeros((L, 2, 64, HKV, 128))
    assert kernel_family(wide) == "aligned"
    rpa.ragged_paged_attention(torch.zeros((3, HQ, 128)), wide, 0, _t(dec["pt"]),
                               _t(dec["kv_lens"].astype(np.int32)), None, **kw)
    assert seen[-1] == "rpa_decode_aligned"
    narrow = torch.zeros((L, 2, 64, HKV, 32))
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        check_cuda(torch.zeros((3, HQ, 32)), narrow)


# (B, Hkv, maxP * page_size, SMs): TinyLlama's decode buckets on an H100's
# 132 SMs, from one request to more pairs than the card holds, the long-KV
# case of the card tests, a page table of one page, and none
SPLIT_SHAPES = [(1, 4, 2048, 132), (8, 4, 2048, 132), (16, 4, 8192, 132),
                (32, 4, 2048, 132), (64, 4, 1024, 132), (128, 4, 2048, 132),
                (16, 2, 4112, 132), (3, 4, 65536, 132), (8, 4, 16, 132), (1, 1, 0, 132),
                (5, 1, 1000, 7)]


@pytest.mark.parametrize("B,Hkv,max_kv,sms", SPLIT_SHAPES,
                         ids=[f"b{b}-h{h}-kv{k}-sm{s}" for b, h, k, s in SPLIT_SHAPES])
def test_merged_decode_split_plan_covers_every_position_once(B, Hkv, max_kv, sms):
    """The merged decode's split plan, a function of the shapes and the SM
    count only: its ranges cover [0, maxP * page_size) exactly once and in
    order, in whole rounds of the kernel's block (its step in DECODE_SPLIT),
    no split is empty, and the blocks (B * Hkv * n_split) fill the card at
    most once over."""
    step, blocks_per_sm = rpa_packed.DECODE_SPLIT["rpa_decode_merged"]
    n, length = rpa_packed.decode_split_plan("rpa_decode_merged", B, Hkv, max_kv, sms)
    assert n >= 1 and length > 0 and length % step == 0
    ranges = [(s * length, min((s + 1) * length, max_kv)) for s in range(n)]
    assert [p for a, b in ranges for p in range(a, b)] == list(range(max_kv))
    assert max_kv == 0 or all(b > a for a, b in ranges)
    if n > 1:
        assert B * Hkv * n <= blocks_per_sm * sms
        assert length >= rpa_packed.SPLIT_MIN


def test_merged_decode_split_plan_fills_the_card_at_small_batch():
    """At TinyLlama's b16 x kv8192 the 64 (request, KV head) pairs take 4
    splits each (256 blocks on 132 SMs); at b64 x kv1024 the 256 pairs
    already fill the card and take one."""
    assert rpa_packed.decode_split_plan("rpa_decode_merged", 16, 4, 8192, 132) == (4, 2048)
    assert rpa_packed.decode_split_plan("rpa_decode_merged", 64, 4, 1024, 132) == (1, 1024)


# ------------------------------------------------------------------ engine
TINYLLAMA = dict(architecture="LlamaForCausalLM", vocab_size=512, hidden_size=256,
                 intermediate_size=512, num_hidden_layers=L, num_attention_heads=32,
                 num_key_value_heads=4, head_dim=64, max_position_embeddings=512,
                 context_length=512, rope_theta=10000.0, rms_norm_eps=1e-5,
                 dtype="float32")
SERVE = dict(page_size=PS, max_total_tokens=2048, chunked_prefill_size=64)


@pytest.mark.parametrize("kv", ["float32", "bfloat16", "fp8_e4m3_scales"])
@pytest.mark.parametrize("semi_pd", [False, True], ids=["colocated", "semi_pd"])
def test_engine_greedy_tokens_match_jax_at_tinyllama_geometry(tmp_path, semi_pd, kv):
    """The port's Engine at TinyLlama's head geometry serves from the 5D
    pool through the merged path and gives the JAX Engine's greedy tokens
    exactly: float32, bf16 (weights and KV), and fp8_e4m3 KV with a
    per-layer scales file."""
    cfg, extra = dict(TINYLLAMA), {}
    if kv == "bfloat16":
        cfg["dtype"] = "bfloat16"
    if kv == "fp8_e4m3_scales":
        path = tmp_path / "kv_scales.json"
        path.write_text(json.dumps({"0": 0.05, "1": 0.02}))
        extra = dict(kv_cache_dtype="fp8_e4m3", quantization_param_path=str(path))
    jeng = JaxEngine(server_args=JaxServerArgs(model_path="", random_weights=True,
                                               enable_semi_pd=semi_pd, **SERVE, **extra),
                     model_config=JaxModelConfig(**cfg))
    teng = Engine(ServerArgs(random_weights=True, enable_semi_pd=semi_pd, device="cpu",
                             **SERVE, **extra), ModelConfig(**cfg), device="cpu")
    teng.runner.model.load_jax_params(jax.tree.map(np.asarray, jeng.runner.params))
    buf = teng.runner.kv_cache.buffer
    assert buf.shape[1:] == (2, buf.shape[2], 4, 64)  # the 5D pool at head_dim 64
    assert kernel_family(buf) == "merged"
    assert buf.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16,
                         "fp8_e4m3_scales": torch.float8_e4m3fn}[kv]

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, size=n).tolist() for n in (20, 100, 37)]
    sp = dict(max_new_tokens=6, temperature=0.0, ignore_eos=True)
    jout = jeng.generate(input_ids=prompts, sampling_params=JaxSamplingParams(**sp))
    tout = teng.generate(input_ids=prompts, sampling_params=SamplingParams(**sp),
                         return_logprob=True)
    assert [o["output_ids"] for o in tout] == [o["output_ids"] for o in jout]
    assert all(np.isfinite(o["meta_info"]["output_logprobs"]).all() for o in tout)
    assert teng.flush_cache() and jeng.flush_cache()
