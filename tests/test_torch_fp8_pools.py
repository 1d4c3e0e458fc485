"""fp8 KV (e4m3, e5m2) on the chunked pool and fp8 latent rows on the MLA
latent pool: the port against the JAX package on the CPU, with the same
numpy inputs.

- The port's plain decode, extend and streaming decode over an fp8 chunked
  pool against the TPU kernels _rpa_kernel_chunked_packed,
  _rpa_kernel_chunked and _rpa_kernel_chunked_stream, in interpret mode.
- The same three over fp8 latent rows against _rpa_kernel_packed's,
  _rpa_kernel's and _rpa_kernel_stream's MLA branches, in interpret mode,
  and the extend at q_len 140 against the JAX reference attention (the JAX
  MLA extend kernel leaves rows 64-127 of each 128-row work-list entry
  unwritten, ROADMAP C1).
- What the kernels take: fp8 under bf16 q; float32 q over fp8 is refused
  before a launch.
- The Engine's greedy tokens against the JAX Engine's on a tiny chunked-pool
  Llama (Hkv 8, head_dim 64) with fp8_e4m3 KV, without and with a
  per-layer scales file, and on a tiny DeepSeek-V2 with fp8_e4m3 latent
  rows, colocated and semi-PD; the scales stay refused for MLA, as in JAX.

Geometry: the chunked pool at tests/test_torch_attention.py's (Hq 8, Hkv 2,
D 64) and, for the stream, tests/test_torch_stream.py's (Hq 8, Hkv 4);
the latent pool at tests/test_torch_mla.py's (Hq 4, a 128 + 64 latent row,
zero-padded to 256 for the JAX kernels, which need a multiple of 256; fp8
zeros leave every score unchanged). Page 16. fp8 pools are made once in
numpy with ml_dtypes and torch gets the same bytes, so both sides read
identical values; both widen them exactly (every fp8 value is a float32).

Tolerances: attention outputs 2e-5 (float32 q on both sides: an online
softmax against a full one, or two full ones summed in another order),
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
    ragged_paged_attention_chunked as jax_chunked,
)
from semi_pd_tpu.ops.attention.reference import (
    ragged_paged_attention_reference as jax_reference,
)
from semi_pd_tpu.ops.attention.rpa_packed import (
    ragged_paged_attention_chunked_packed as jax_chunked_packed,
    ragged_paged_attention_packed as jax_packed,
)
from semi_pd_tpu.runtime.engine import Engine as JaxEngine
from semi_pd_tpu.runtime.forward_batch import build_attn_meta as jax_meta
from semi_pd_tpu.sampling.sampling_params import SamplingParams as JaxSamplingParams

from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.config.server_args import ServerArgs
from semi_pd_tpu_torch.ops.attention import ragged_paged_attention as rpa
from semi_pd_tpu_torch.ops.attention import rpa_packed
from semi_pd_tpu_torch.runtime.engine import Engine
from semi_pd_tpu_torch.runtime.forward_batch import build_attn_meta
from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams

PS, L = 16, 2
HQ, HKV, D = 8, 2, 64  # the chunked pool (decode, extend)
HKV_STREAM = 4  # the chunked stream's
HQ_MLA, LORA, ROPE, DPAD = 4, 128, 64, 256
DLAT = LORA + ROPE
KV = ["fp8_e4m3", "fp8_e5m2"]
ML_FP8 = {"fp8_e4m3": ml_dtypes.float8_e4m3fn, "fp8_e5m2": ml_dtypes.float8_e5m2}
TORCH_FP8 = {"fp8_e4m3": torch.float8_e4m3fn, "fp8_e5m2": torch.float8_e5m2}
TOL = 2e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _fp8_pair(pool: np.ndarray, kv: str):
    """The pool in fp8 for JAX (numpy of the ml_dtypes type) and for torch
    (the same bytes)."""
    p8 = pool.astype(ML_FP8[kv])
    return p8, _t(p8.view(np.uint8)).view(TORCH_FP8[kv])


def _pad(a, width=DPAD):
    return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, width - a.shape[-1])])


def _setup(seed, q_lens, kv_lens, kv, pool_shape, q_width, hq, pad_T=0, pad_B=0, scale=1.0):
    """Numpy inputs: an fp8 pool of ``pool_shape`` (slots in its second
    axis, or third on the latent pool), queries [T, hq, q_width], a shuffled
    page table and the per-request lengths, with optional bucket padding."""
    rng = np.random.default_rng(seed)
    B = len(kv_lens) + pad_B
    n_pages = [-(-k // PS) for k in kv_lens]
    total = sum(n_pages) + 2
    perm = rng.permutation(np.arange(1, total))
    pt = np.zeros((B, max(max(n_pages), 1) + 1), np.int32)
    used = 0
    for b, n in enumerate(n_pages):
        pt[b, :n] = perm[used:used + n]
        used += n
    pool = (rng.normal(size=pool_shape(total * PS)) * scale).astype(np.float32)
    T = sum(q_lens) + pad_T
    q = (rng.normal(size=(T, hq, q_width)) * scale).astype(np.float32)
    ql = np.zeros(B, np.int64)
    ql[: len(q_lens)] = q_lens
    kl = np.zeros(B, np.int64)
    kl[: len(kv_lens)] = kv_lens
    jpool, tpool = _fp8_pair(pool, kv)
    return dict(q=q, jpool=jpool, tpool=tpool, pt=pt, q_lens=ql, kv_lens=kl, T=T)


def _chunked(seed, q_lens, kv_lens, kv, hkv=HKV, **kw):
    return _setup(seed, q_lens, kv_lens, kv, lambda S: (L, S, 2 * hkv * D // 128, 128), D, HQ,
                  **kw)


def _latent(seed, q_lens, kv_lens, kv, **kw):
    return _setup(seed, q_lens, kv_lens, kv, lambda S: (L, 1, S, 1, DLAT), DLAT, HQ_MLA,
                  scale=0.5, **kw)


def _live(out, ref, kvl):
    live = kvl > 0
    np.testing.assert_allclose(out[live], ref[live], rtol=TOL, atol=TOL)
    assert not out[~live].any(), "rows with kv_len == 0 must be zeros"


# ------------------------------------------------------------ chunked pool
@pytest.mark.parametrize("kv", KV)
def test_chunked_decode_over_fp8_matches_jax_packed_kernel(kv):
    """A padded row among ragged kv_lens; float32 q over the fp8 pool."""
    kv_lens = [33, 5, 0, 64, 17, 160, 9]
    d = _chunked(3, [1] * len(kv_lens), kv_lens, kv)
    kvl = np.asarray(kv_lens, np.int32)
    ref = np.asarray(jax_chunked_packed(
        jnp.asarray(d["q"]), jnp.asarray(d["jpool"]), 1, jnp.asarray(d["pt"]),
        jnp.asarray(kvl), page_size=PS, num_kv_heads=HKV, head_dim=D, scale=0.125, rpb=2,
        kv_block=32, interpret=True))
    out = rpa_packed.ragged_paged_attention_chunked_packed(
        _t(d["q"]), d["tpool"], 1, _t(d["pt"]), _t(kvl), page_size=PS, num_kv_heads=HKV,
        head_dim=D, scale=0.125).numpy()
    _live(out, ref, kvl)


@pytest.mark.parametrize("kv", KV)
def test_chunked_extend_over_fp8_matches_jax_chunked_kernel(kv):
    """q_len 140 spans two work-list blocks; prefix + new tokens; a padded
    batch row and padded token rows; softcap 5."""
    q_lens, kv_lens = [140, 20, 1, 7], [140, 60, 9, 30]
    d = _chunked(4, q_lens, kv_lens, kv, pad_T=9, pad_B=1)
    T, kvl = d["T"], d["kv_lens"].astype(np.int32)
    ref = np.asarray(jax_chunked(
        jnp.asarray(d["q"]), jnp.asarray(d["jpool"]), 1, jnp.asarray(d["pt"]),
        jnp.asarray(kvl), jax_meta(d["q_lens"], d["kv_lens"], T), page_size=PS,
        num_kv_heads=HKV, head_dim=D, scale=0.125, logit_cap=5.0, interpret=True,
        force_blocked=True))
    out = rpa.ragged_paged_attention_chunked(
        _t(d["q"]), d["tpool"], 1, _t(d["pt"]), _t(kvl), build_attn_meta(d["q_lens"],
                                                                        d["kv_lens"], T),
        page_size=PS, num_kv_heads=HKV, head_dim=D, scale=0.125, logit_cap=5.0).numpy()
    n = sum(q_lens)
    np.testing.assert_allclose(out[:n], ref[:n], rtol=TOL, atol=TOL)
    assert not out[n:].any(), "bucket-padding rows must stay zero"


@pytest.mark.parametrize("kv", KV)
def test_chunked_stream_over_fp8_matches_jax_chunked_stream_kernel(kv):
    """kv_lens that straddle the 16-position blocks and a kv_len-0 row,
    through the port's streaming route (``stream=True``)."""
    kv_lens = [33, 0, 70, 17, 48]
    d = _chunked(1, [1] * len(kv_lens), kv_lens, kv, hkv=HKV_STREAM)
    kvl = np.asarray(kv_lens, np.int32)
    meta = (np.ones(len(kv_lens), np.int64), kvl.astype(np.int64), len(kv_lens))
    ref = np.asarray(jax_chunked(
        jnp.asarray(d["q"]), jnp.asarray(d["jpool"]), 1, jnp.asarray(d["pt"]),
        jnp.asarray(kvl), jax_meta(*meta), page_size=PS, num_kv_heads=HKV_STREAM,
        head_dim=D, scale=0.125, logit_cap=5.0, interpret=True, kv_block=16, stream=True))
    out = rpa.ragged_paged_attention_chunked(
        _t(d["q"]), d["tpool"], 1, _t(d["pt"]), _t(kvl), build_attn_meta(*meta), page_size=PS,
        num_kv_heads=HKV_STREAM, head_dim=D, scale=0.125, logit_cap=5.0, stream=True).numpy()
    _live(out, ref, kvl)


# ------------------------------------------------------------- latent pool
@pytest.mark.parametrize("kv", KV)
def test_latent_decode_over_fp8_matches_jax_packed_kernel(kv):
    """_rpa_kernel_packed's MLA branch over the zero-padded fp8 rows."""
    kv_lens = [33, 5, 0, 64, 17, 160, 9]
    d = _latent(3, [1] * len(kv_lens), kv_lens, kv)
    kvl = np.asarray(kv_lens, np.int32)
    ref = np.asarray(jax_packed(
        jnp.asarray(_pad(d["q"])), jnp.asarray(_pad(d["jpool"])), 1, jnp.asarray(d["pt"]),
        jnp.asarray(kvl), page_size=PS, scale=DLAT ** -0.5, v_dim=LORA, rpb=2, kv_block=64,
        interpret=True))
    out = rpa_packed.ragged_paged_attention_packed(
        _t(d["q"]), d["tpool"], 1, _t(d["pt"]), _t(kvl), page_size=PS, scale=DLAT ** -0.5,
        v_dim=LORA).numpy()
    assert out.shape == (len(kv_lens), HQ_MLA, LORA)
    _live(out, ref, kvl)


@pytest.mark.parametrize("kv", KV)
def test_latent_extend_over_fp8_matches_jax_kernel(kv):
    """_rpa_kernel's MLA branch, q_len <= 64 (the rows it writes, C1):
    prefix + new tokens, a padded batch row and padded token rows."""
    q_lens, kv_lens = [40, 20, 1, 7], [140, 60, 9, 30]
    d = _latent(4, q_lens, kv_lens, kv, pad_T=9, pad_B=1)
    T, kvl = d["T"], d["kv_lens"].astype(np.int32)
    ref = np.asarray(jax_rpa(
        jnp.asarray(_pad(d["q"])), jnp.asarray(_pad(d["jpool"])), 1, jnp.asarray(d["pt"]),
        jnp.asarray(kvl), jax_meta(d["q_lens"], d["kv_lens"], T), page_size=PS,
        scale=DLAT ** -0.5, v_dim=LORA, interpret=True))
    out = rpa.ragged_paged_attention(
        _t(d["q"]), d["tpool"], 1, _t(d["pt"]), _t(kvl),
        build_attn_meta(d["q_lens"], d["kv_lens"], T), page_size=PS, scale=DLAT ** -0.5,
        v_dim=LORA).numpy()
    n = sum(q_lens)
    np.testing.assert_allclose(out[:n], ref[:n], rtol=TOL, atol=TOL)
    assert not out[n:].any(), "bucket-padding rows must stay zero"


@pytest.mark.parametrize("kv", KV)
def test_latent_extend_q_len_140_over_fp8_matches_jax_reference(kv):
    """q_len 140 (two work-list entries, rows past 64 included) against
    the JAX reference attention over the same fp8 rows, window 40."""
    q_lens, kv_lens = [140, 3], [200, 40]
    d = _latent(6, q_lens, kv_lens, kv, pad_T=4)
    T, kvl = d["T"], d["kv_lens"].astype(np.int32)
    qri = np.zeros(T, np.int32)
    qpos = np.zeros(T, np.int32)
    o = 0
    for b, (ql, kl) in enumerate(zip(q_lens, kv_lens)):
        qri[o:o + ql] = b
        qpos[o:o + ql] = np.arange(kl - ql, kl)
        o += ql
    ref = np.asarray(jax_reference(
        jnp.asarray(d["q"]), jnp.asarray(d["jpool"]), 1, jnp.asarray(d["pt"]),
        jnp.asarray(qri), jnp.asarray(qpos), jnp.asarray(kvl), page_size=PS,
        scale=DLAT ** -0.5, v_dim=LORA, sliding_window=40))
    out = rpa.ragged_paged_attention(
        _t(d["q"]), d["tpool"], 1, _t(d["pt"]), _t(kvl),
        build_attn_meta(d["q_lens"], d["kv_lens"], T), page_size=PS, scale=DLAT ** -0.5,
        v_dim=LORA, sliding_window=40).numpy()
    n = sum(q_lens)
    np.testing.assert_allclose(out[:n], ref[:n], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kv", KV)
def test_latent_stream_over_fp8_matches_jax_stream_kernel(kv, monkeypatch):
    """_rpa_kernel_stream's MLA branch (RPA_DECODE_STREAM=1, set on the
    JAX call only) against the port's streaming route."""
    kv_lens = [33, 0, 70, 17, 48]
    d = _latent(5, [1] * len(kv_lens), kv_lens, kv)
    kvl = np.asarray(kv_lens, np.int32)
    meta = (np.ones(len(kv_lens), np.int64), kvl.astype(np.int64), len(kv_lens))
    with monkeypatch.context() as m:
        m.setenv("RPA_DECODE_STREAM", "1")
        m.setenv("RPA_STREAM_NBUF", "3")
        ref = np.asarray(jax_rpa(
            jnp.asarray(_pad(d["q"])), jnp.asarray(_pad(d["jpool"])), 1, jnp.asarray(d["pt"]),
            jnp.asarray(kvl), jax_meta(*meta), page_size=PS, scale=DLAT ** -0.5, v_dim=LORA,
            kv_block=16, interpret=True))
    out = rpa.ragged_paged_attention(
        _t(d["q"]), d["tpool"], 1, _t(d["pt"]), _t(kvl), build_attn_meta(*meta), page_size=PS,
        scale=DLAT ** -0.5, v_dim=LORA, stream=True).numpy()
    _live(out, ref, kvl)


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("pool", ["chunked", "latent"])
def test_kernels_take_fp8_under_bf16_q_only(pool, kv):
    """What a wrapper checks before a launch (rpa_common.check_cuda): the
    chunked and the latent builds take an fp8 pool under bf16 q, as the
    aligned and merged ones do; under float32 q, which the plain versions
    take, the kernels refuse it rather than run another path."""
    from semi_pd_tpu_torch.ops.attention.rpa_common import check_cuda

    if pool == "chunked":
        fp8 = torch.zeros((L, 4 * PS, 8, 128), dtype=TORCH_FP8[kv])
        width, extra = D, {}
    else:
        fp8 = torch.zeros((L, 1, 4 * PS, 1, 576), dtype=TORCH_FP8[kv])
        width, extra = 576, {"v_dim": 512}
    ints = (torch.zeros((2, 4), dtype=torch.int32), torch.zeros(2, dtype=torch.int32))
    check_cuda(torch.zeros((2, 16, width), dtype=torch.bfloat16), fp8, *ints, **extra)
    with pytest.raises(ValueError, match="dtypes"):
        check_cuda(torch.zeros((2, 16, width)), fp8, *ints, **extra)


# ------------------------------------------------------------------ engine
SERVE = dict(page_size=PS, max_total_tokens=2048, chunked_prefill_size=64)
LLAMA = dict(architecture="LlamaForCausalLM", vocab_size=512, hidden_size=256,
             intermediate_size=512, num_hidden_layers=L, num_attention_heads=8,
             num_key_value_heads=8, head_dim=D, max_position_embeddings=512,
             context_length=512, rope_theta=10000.0, dtype="float32")
DEEPSEEK = dict(architecture="DeepseekV2ForCausalLM", vocab_size=256, hidden_size=128,
                intermediate_size=192, num_hidden_layers=2, num_attention_heads=HQ_MLA,
                num_key_value_heads=HQ_MLA, head_dim=64 + ROPE, rms_norm_eps=1e-6,
                max_position_embeddings=512, context_length=512, rope_theta=10000.0,
                use_mla=True, q_lora_rank=None, kv_lora_rank=LORA, qk_nope_head_dim=64,
                qk_rope_head_dim=ROPE, v_head_dim=64, num_experts=8, num_experts_per_tok=2,
                moe_intermediate_size=48, num_shared_experts=1, first_k_dense_replace=1,
                topk_method="greedy", dtype="float32")


def _scales_file(tmp_path):
    path = tmp_path / "kv_scales.json"
    path.write_text(json.dumps(
        {"kv_cache": {"dtype": "float8_e4m3fn",
                      "scaling_factor": {"0": {"0": 0.05, "1": 0.02}}}}))
    return str(path)


def _same_greedy_tokens(cfg, vocab, semi_pd, extra, layout):
    """The JAX Engine and the port's Engine (on the CPU, holding the JAX
    parameters) serve two prompts greedily, one of them over two prefill
    chunks: the port's pool has the layout and fp8 dtype asked for, and the
    tokens are the JAX Engine's."""
    jeng = JaxEngine(server_args=JaxServerArgs(model_path="", random_weights=True,
                                               enable_semi_pd=semi_pd, **SERVE, **extra),
                     model_config=JaxModelConfig(**cfg))
    teng = Engine(ServerArgs(random_weights=True, enable_semi_pd=semi_pd, device="cpu",
                             **SERVE, **extra), ModelConfig(**cfg), device="cpu")
    teng.runner.model.load_jax_params(jax.tree.map(np.asarray, jeng.runner.params))
    buf = teng.runner.kv_cache.buffer
    assert teng.runner.kv_spec.layout == layout and buf.dtype == torch.float8_e4m3fn
    assert teng.runner.kv_spec.bytes_total() == buf.numel()  # 1-byte slots
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, size=n).tolist() for n in (20, 100)]
    sp = dict(max_new_tokens=6, temperature=0.0, ignore_eos=True)
    jout = jeng.generate(input_ids=prompts, sampling_params=JaxSamplingParams(**sp))
    tout = teng.generate(input_ids=prompts, sampling_params=SamplingParams(**sp),
                         return_logprob=True)
    assert [o["output_ids"] for o in tout] == [o["output_ids"] for o in jout]
    assert all(np.isfinite(o["meta_info"]["output_logprobs"]).all() for o in tout)
    assert teng.flush_cache() and jeng.flush_cache()
    return teng


@pytest.mark.parametrize("scales", [False, True], ids=["fp8_e4m3", "fp8_e4m3_scales"])
@pytest.mark.parametrize("semi_pd", [False, True], ids=["colocated", "semi_pd"])
def test_engine_fp8_on_the_chunked_pool_matches_jax(tmp_path, semi_pd, scales):
    """Hkv 8 at head_dim 64: the chunked pool [L, S, 8, 128] in fp8_e4m3,
    with and without a per-layer scales file (applied outside the kernels
    by linearity)."""
    extra = dict(kv_cache_dtype="fp8_e4m3")
    if scales:
        extra["quantization_param_path"] = _scales_file(tmp_path)
    teng = _same_greedy_tokens(LLAMA, 512, semi_pd, extra, "chunked")
    assert teng.runner.kv_cache.buffer.shape[2:] == (8, 128)
    assert (teng.runner.kv_scales is not None) == scales


@pytest.mark.parametrize("semi_pd", [False, True], ids=["colocated", "semi_pd"])
def test_engine_fp8_latent_rows_match_jax(semi_pd):
    """The tiny DeepSeek-V2 on its exact 192-wide latent pool in fp8_e4m3
    (the JAX pool is padded to 256)."""
    teng = _same_greedy_tokens(DEEPSEEK, 256, semi_pd, dict(kv_cache_dtype="fp8_e4m3"),
                               "latent")
    assert teng.runner.kv_cache.buffer.shape[-1] == DLAT and teng.runner.kv_scales is None


def test_runner_refuses_kv_scales_for_mla_as_jax_does(tmp_path):
    """Per-layer KV scales do not apply to the latent pool's one row: both
    runners refuse them for MLA, with fp8 latent rows or without."""
    extra = dict(kv_cache_dtype="fp8_e4m3", quantization_param_path=_scales_file(tmp_path))
    with pytest.raises(ValueError, match="MLA"):
        JaxEngine(server_args=JaxServerArgs(model_path="", random_weights=True, **SERVE,
                                            **extra), model_config=JaxModelConfig(**DEEPSEEK))
    with pytest.raises(ValueError, match="MLA"):
        Engine(ServerArgs(random_weights=True, device="cpu", **SERVE, **extra),
               ModelConfig(**DEEPSEEK), device="cpu")
