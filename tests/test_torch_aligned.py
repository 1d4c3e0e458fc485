"""The port's aligned-pool path (``[L, 2, S, Hkv, D]``, head_dim 128, bf16,
float32 or fp8 KV) against the JAX package on the CPU, with the same numpy
inputs:

- the plain aligned decode against the TPU kernel _rpa_kernel_packed and the
  plain aligned extend against the TPU kernel _rpa_kernel, both in interpret
  mode (float32 queries over float32, fp8_e4m3 and fp8_e5m2 pools);
- the 5D KV write and the fp8-KV scales (applied by linearity) against the
  JAX layer on its reference backend;
- the scales-file parser, the pool layout rule, fp8 rounding, the on-device
  random init, and the Engine's greedy tokens against the JAX Engine.

Geometry: Hq 8, Hkv 2, D 128 (G = 4, as on Llama-3-8B), page 16, 2 layers.
fp8 pools are made once in numpy with ml_dtypes; torch gets the same bytes
(``.view(np.uint8)`` then ``.view(torch.float8_*)``), so both sides read
identical values.

Tolerances: attention outputs 2e-5 (float32 on both sides: an online
softmax against a full one, or two full ones with another summation order);
the layer's pool after the write must be bit-identical; greedy tokens must
be identical.
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
from semi_pd_tpu.layers import attention as jax_attention
from semi_pd_tpu.ops.attention.ragged_paged_attention import (
    ragged_paged_attention as jax_rpa,
)
from semi_pd_tpu.ops.attention.rpa_packed import (
    ragged_paged_attention_packed as jax_packed,
)
from semi_pd_tpu.runtime.engine import Engine as JaxEngine
from semi_pd_tpu.runtime.forward_batch import ForwardArrays as JaxFB
from semi_pd_tpu.runtime.forward_batch import build_attn_meta as jax_meta
from semi_pd_tpu.runtime.model_runner import _load_kv_cache_scales as jax_load_scales
from semi_pd_tpu.sampling.sampling_params import SamplingParams as JaxSamplingParams

from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.config.server_args import ServerArgs
from semi_pd_tpu_torch.layers.attention import paged_attention
from semi_pd_tpu_torch.model_loader.loader import device_init_params
from semi_pd_tpu_torch.models.llama import LlamaForCausalLM
from semi_pd_tpu_torch.ops.attention import ragged_paged_attention as rpa
from semi_pd_tpu_torch.ops.attention import rpa_packed
from semi_pd_tpu_torch.runtime.engine import Engine
from semi_pd_tpu_torch.runtime.forward_batch import ForwardArrays, build_attn_meta
from semi_pd_tpu_torch.runtime.model_runner import _load_kv_cache_scales, kv_pool_layout
from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams

HQ, HKV, D, PS, L = 8, 2, 128, 16, 2
SCALE = D ** -0.5
ML_FP8 = {"fp8_e4m3": ml_dtypes.float8_e4m3fn, "fp8_e5m2": ml_dtypes.float8_e5m2}
TORCH_FP8 = {"fp8_e4m3": torch.float8_e4m3fn, "fp8_e5m2": torch.float8_e5m2}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pool_pair(pool: np.ndarray, kv: str):
    """The same pool for JAX (numpy of the KV dtype) and torch (the same
    bytes): float32, or made once in numpy with ml_dtypes for fp8."""
    if kv == "float32":
        return pool, _t(pool)
    p8 = pool.astype(ML_FP8[kv])
    return p8, _t(p8.view(np.uint8)).view(TORCH_FP8[kv])


def _setup(seed, q_lens, kv_lens, pad_T=0, pad_B=0, kv="float32"):
    """Numpy inputs: aligned pool, queries, a shuffled page table and the
    per-request lengths, with optional bucket padding of T and B."""
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
    pool = rng.normal(size=(L, 2, total * PS, HKV, D)).astype(np.float32)
    T = sum(q_lens) + pad_T
    q = rng.normal(size=(T, HQ, D)).astype(np.float32)
    ql = np.zeros(B, np.int64)
    ql[: len(q_lens)] = q_lens
    kl = np.zeros(B, np.int64)
    kl[: len(kv_lens)] = kv_lens
    jpool, tpool = _pool_pair(pool, kv)
    return dict(q=q, jpool=jpool, tpool=tpool, pt=pt, q_lens=ql, kv_lens=kl, T=T)


DECODE_CASES = {
    "ragged_padded_row": ([33, 5, 0, 64, 17, 160, 9], {}, "float32"),
    "softcap": ([70, 18, 3, 41], {"logit_cap": 5.0}, "float32"),
    "window": ([70, 18, 3, 41], {"sliding_window": 24}, "float32"),
    "fp8_e4m3": ([33, 5, 0, 64, 17, 160, 9], {}, "fp8_e4m3"),
    "fp8_e5m2": ([70, 18, 3, 41], {"sliding_window": 24}, "fp8_e5m2"),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_aligned_decode_plain_matches_jax_packed_kernel(case):
    """The port's plain aligned decode against _rpa_kernel_packed (interpret)."""
    kv_lens, kw, kv = DECODE_CASES[case]
    B = len(kv_lens)
    d = _setup(3, [1] * B, kv_lens, kv=kv)
    kvl = np.asarray(kv_lens, np.int32)
    ref = np.asarray(jax_packed(
        jnp.asarray(d["q"]), jnp.asarray(d["jpool"]), 1, jnp.asarray(d["pt"]),
        jnp.asarray(kvl), page_size=PS, scale=SCALE, rpb=2, kv_block=64,
        interpret=True, **kw))
    out = rpa_packed.ragged_paged_attention_packed(
        _t(d["q"]), d["tpool"], 1, _t(d["pt"]), _t(kvl), page_size=PS, scale=SCALE,
        **kw).numpy()
    live = kvl > 0
    np.testing.assert_allclose(out[live], ref[live], rtol=2e-5, atol=2e-5)
    assert not out[~live].any(), "rows with kv_len == 0 must be zeros"


EXTEND_CASES = {
    # prefix + new tokens, q_len > 128 spans two work-list blocks, a padded
    # batch row and padded token rows; T >= 128, the JAX kernel's q-block
    "multi_block_prefix": ([140, 20, 1, 7], [140, 60, 9, 30], {}, "float32"),
    "softcap": ([40, 130, 7], [90, 130, 57], {"logit_cap": 5.0}, "float32"),
    "window": ([60, 33, 129], [60, 50, 200], {"sliding_window": 16}, "float32"),
    "fp8_e4m3": ([140, 20, 1, 7], [140, 60, 9, 30], {}, "fp8_e4m3"),
}


@pytest.mark.parametrize("case", sorted(EXTEND_CASES))
def test_aligned_extend_plain_matches_jax_kernel(case):
    """The port's plain aligned extend against _rpa_kernel (interpret) on a
    non-decode batch with the same work list (q-block 128)."""
    q_lens, kv_lens, kw, kv = EXTEND_CASES[case]
    d = _setup(4, q_lens, kv_lens, pad_T=9, pad_B=1, kv=kv)
    T, kvl = d["T"], d["kv_lens"].astype(np.int32)
    ref = np.asarray(jax_rpa(
        jnp.asarray(d["q"]), jnp.asarray(d["jpool"]), 1, jnp.asarray(d["pt"]),
        jnp.asarray(kvl), jax_meta(d["q_lens"], d["kv_lens"], T), page_size=PS,
        scale=SCALE, interpret=True, **kw))
    meta = build_attn_meta(d["q_lens"], d["kv_lens"], T)
    out = rpa.ragged_paged_attention(
        _t(d["q"]), d["tpool"], 1, _t(d["pt"]), _t(kvl), meta, page_size=PS,
        scale=SCALE, **kw).numpy()
    n = sum(q_lens)
    np.testing.assert_allclose(out[:n], ref[:n], rtol=2e-5, atol=2e-5)
    assert not out[n:].any(), "bucket-padding rows must stay zero"


def test_aligned_routing_and_refusals():
    """T == B goes to the decode path, as the JAX wrapper decides; v_dim
    (MLA) is refused on the aligned pool, speculation masks raise with their
    ROADMAP item; fp8 KV is taken on the aligned pool and on the chunked
    pool alike, under float32 q (and bf16 q on the card), never under
    another q dtype."""
    d = _setup(5, [1, 1, 1], [12, 40, 7])
    q, pool, pt = _t(d["q"]), d["tpool"], _t(d["pt"])
    kvl = _t(d["kv_lens"].astype(np.int32))
    meta = build_attn_meta(d["q_lens"], d["kv_lens"], d["T"])
    kw = dict(page_size=PS, scale=SCALE)
    a = rpa.ragged_paged_attention(q, pool, 0, pt, kvl, meta, **kw)
    b = rpa_packed.ragged_paged_attention_packed_plain(q, pool, 0, pt, kvl, **kw)
    e = rpa.ragged_paged_attention_extend_plain(q, pool, 0, pt, kvl, meta, **kw)
    assert torch.equal(a, b)
    torch.testing.assert_close(a, e, rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="latent pool"):
        rpa.ragged_paged_attention(q, pool, 0, pt, kvl, meta, v_dim=64, **kw)
    # a speculation tree needs its window starts (the tree itself is
    # tests/test_torch_spec_mask.py's)
    with pytest.raises(ValueError, match="go together"):
        rpa.ragged_paged_attention(q, pool, 0, pt, kvl, meta, spec_anc=(1,), **kw)
    fp8 = pool.to(torch.float8_e4m3fn)
    out = rpa_packed.ragged_paged_attention_packed(q, fp8, 0, pt, kvl, **kw)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    # the same fp8 values as the chunked pool's slot rows (K heads, then V)
    chunked = fp8.permute(0, 2, 1, 3, 4).reshape(L, pool.shape[2], 2 * HKV * D // 128, 128)
    out_c = rpa_packed.ragged_paged_attention_chunked_packed(
        q, chunked.contiguous(), 0, pt, kvl, num_kv_heads=HKV, head_dim=D, **kw)
    assert out_c.dtype == torch.float32 and torch.equal(out_c, out)
    with pytest.raises(ValueError, match="dtype"):
        rpa_packed.ragged_paged_attention_packed(q.double(), fp8, 0, pt, kvl, **kw)
    with pytest.raises(RuntimeError, match="no decode kernel"):
        rpa_packed.ragged_paged_attention_packed(
            q.to("meta"), pool.to("meta"), 0, pt.to("meta"), kvl.to("meta"), **kw)


# ------------------------------------------------------------------ layer
@pytest.mark.parametrize("kv", ["float32", "fp8_e4m3"])
def test_paged_attention_5d_write_and_kv_scales_match_jax(kv):
    """KV write into the aligned pool + attention, with per-layer kv scales
    on the fp8 pool (k/k_s and v/v_s stored, q*k_s and out*v_s applied
    outside the kernels): the pool after the write is bit-identical to the
    JAX layer's (fp8 rounding included) and the output matches within 1e-5."""
    rng = np.random.default_rng(4)
    T, B = 24, 3
    S = 20 * PS
    pool = rng.normal(size=(L, 2, S, HKV, D)).astype(np.float32)
    jpool0, tpool = _pool_pair(pool, kv)
    q = rng.normal(size=(T, HQ, D)).astype(np.float32)
    k = rng.normal(size=(T, HKV, D)).astype(np.float32)
    v = rng.normal(size=(T, HKV, D)).astype(np.float32)
    scales = (np.asarray([[1.0, 1.0], [0.5, 3.0]], np.float32) if kv != "float32"
              else None)
    # three requests: 10 new tokens on a 30-token prefix, 13 fresh, 1 decode
    q_lens, kv_lens = [10, 13, 1], [40, 13, 50]
    pages = [[3, 7, 1], [9], [2, 5, 11, 4]]
    pt = np.zeros((B, 4), np.int32)
    for b, p in enumerate(pages):
        pt[b, : len(p)] = p
    qri, qpos, slots = [], [], []
    for b, (ql, kl) in enumerate(zip(q_lens, kv_lens)):
        for pos in range(kl - ql, kl):
            qri.append(b)
            qpos.append(pos)
            slots.append(pages[b][pos // PS] * PS + pos % PS)
    qri, qpos, slots = (np.asarray(x, np.int32) for x in (qri, qpos, slots))
    kvl = np.asarray(kv_lens, np.int32)
    qlen = np.asarray(q_lens, np.int64)

    jax_attention.set_attention_backend("reference")
    jfb = JaxFB(
        input_ids=jnp.zeros(T, jnp.int32), q_req_idx=jnp.asarray(qri),
        q_pos=jnp.asarray(qpos), out_slots=jnp.asarray(slots),
        page_table=jnp.asarray(pt), kv_lens=jnp.asarray(kvl),
        logits_idx=jnp.zeros(B, jnp.int32), sampling=None,
        rng_key=jax.random.PRNGKey(0), num_reqs=jnp.asarray(B, jnp.int32),
        attn_meta=jax_meta(qlen, kvl.astype(np.int64), T),
        kv_scales=None if scales is None else jnp.asarray(scales))
    jout, jpool = jax_attention.paged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(jpool0), 1, jfb,
        page_size=PS, scale=SCALE)

    fb = ForwardArrays(
        input_ids=None, q_req_idx=_t(qri), q_pos=_t(qpos), out_slots=_t(slots),
        page_table=_t(pt), kv_lens=_t(kvl), logits_idx=None, sampling=None,
        num_reqs=B, attn_meta=build_attn_meta(qlen, kvl, T),
        kv_scales=None if scales is None else _t(scales))
    out = paged_attention(_t(q), _t(k), _t(v), tpool, 1, fb, page_size=PS, scale=SCALE)
    as_bytes = lambda a: np.asarray(a).view(np.uint8)
    np.testing.assert_array_equal(as_bytes(tpool.view(torch.uint8).numpy()
                                           if kv != "float32" else tpool.numpy()),
                                  as_bytes(jpool))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kv", ["fp8_e4m3", "fp8_e5m2"])
def test_fp8_rounding_matches_ml_dtypes_in_range(kv):
    """Every finite fp8 value, every midpoint between neighbours (ties) and
    points just beside them round the same in torch and ml_dtypes (JAX),
    from float32 and from bfloat16. Outside the e4m3 range the two differ,
    and this test pins it: torch saturates to +-448 where ml_dtypes and JAX
    give NaN (e5m2 overflows to inf in both)."""
    mt, tt = ML_FP8[kv], TORCH_FP8[kv]
    allv = np.arange(256, dtype=np.uint8).view(mt).astype(np.float32)
    fin = np.unique(allv[np.isfinite(allv)])
    mids = (fin[1:] + fin[:-1]) / 2
    x = np.concatenate([fin, mids, mids * (1 + 1e-6), mids * (1 - 1e-6)]).astype(np.float32)
    for src in (torch.float32, torch.bfloat16):
        xs = _t(x).to(src)
        want = xs.float().numpy().astype(mt).view(np.uint8)
        np.testing.assert_array_equal(xs.to(tt).view(torch.uint8).numpy(), want)
    big = np.asarray([fin.max() * 1.2, -1e6, np.inf], np.float32)
    ours = _t(big).to(tt).float().numpy()
    theirs = big.astype(mt).astype(np.float32)
    if kv == "fp8_e4m3":
        np.testing.assert_array_equal(ours, [448.0, -448.0, 448.0])
        assert np.isnan(theirs).all()
    else:
        np.testing.assert_array_equal(ours, theirs)
        assert np.isinf(ours).all()


# ------------------------------------------------------------------ runner
SCALE_DOCS = {
    "per_tp_rank": {"kv_cache": {"dtype": "float8_e4m3fn",
                                 "scaling_factor": {"0": {"0": 0.5, "1": 2.0, "7": 9.0}}}},
    "flat": {"0": 0.25, "1": 1.5},
    "per_layer_dicts": {"0": {"k_scale": 0.25, "v_scale": 4.0}, "1": 1.5},
}


@pytest.mark.parametrize("schema", sorted(SCALE_DOCS))
def test_kv_cache_scales_parse_like_jax(tmp_path, schema):
    path = tmp_path / "kv_scales.json"
    path.write_text(json.dumps(SCALE_DOCS[schema]))
    ours = _load_kv_cache_scales(str(path), 2)
    assert ours.dtype == np.float32 and ours.shape == (2, 2)
    np.testing.assert_array_equal(ours, jax_load_scales(str(path), 2))


LAYOUTS = [
    # (Hkv, D): the pool of the JAX runner's rule (chunked iff D % 128 != 0,
    # 128 % D == 0 and (2*Hkv*D) % 1024 == 0; the 5D "aligned" pool
    # otherwise), or the ROADMAP item the geometry waits for
    ((8, 64), "chunked"),  # Llama-3.2-1B
    ((2, 64), "aligned"),  # Qwen2.5-0.5B: the merged kernels
    ((1, 64), "aligned"),
    ((4, 64), "aligned"),  # TinyLlama-1.1B
    ((16, 64), "chunked"),
    ((4, 32), "A9"),  # 5D pool at head_dim 32: no build
    ((8, 16), "A9"),
    ((8, 128), "aligned"),  # Llama-3-8B, Qwen2.5-7B, Mistral-7B
    ((2, 128), "aligned"),
    ((1, 128), "aligned"),
    ((8, 256), "aligned"),  # Gemma-2-9B: the _256 builds
    ((4, 256), "aligned"),
    ((4, 512), "A9"),
    ((1, 32), "A9"),
    ((2, 16), "A9"),
    ((8, 96), "A9"),  # 128 % D != 0
    ((8, 80), "A9"),
]


@pytest.mark.parametrize("geometry,want", LAYOUTS, ids=[f"{h}x{d}" for (h, d), _ in LAYOUTS])
def test_kv_pool_layout_rule(geometry, want):
    if want in ("chunked", "aligned"):
        assert kv_pool_layout(*geometry) == want
    else:
        with pytest.raises(NotImplementedError, match=f"ROADMAP {want}"):
            kv_pool_layout(*geometry)


@pytest.mark.parametrize("kv", ["fp8_e4m3", "fp8_e5m2"])
def test_fp8_kv_on_the_chunked_pool_is_served(kv):
    """Hkv 8 at head_dim 64 is on the chunked pool (Hkv 2 would be on the
    5D pool): with fp8 KV the runner builds it as [L, S, 8, 128] in the fp8
    dtype, sized in 1-byte slots, and serves greedy tokens."""
    cfg = ModelConfig(architecture="LlamaForCausalLM", vocab_size=64, hidden_size=128,
                      intermediate_size=128, num_hidden_layers=1, num_attention_heads=8,
                      num_key_value_heads=8, head_dim=64, context_length=128,
                      dtype="float32")
    eng = Engine(ServerArgs(random_weights=True, device="cpu", max_total_tokens=256,
                            kv_cache_dtype=kv), cfg, device="cpu")
    buf = eng.runner.kv_cache.buffer
    assert eng.runner.kv_spec.layout == "chunked" and buf.shape[2:] == (8, 128)
    assert buf.dtype == TORCH_FP8[kv]
    assert eng.runner.kv_spec.bytes_total() == buf.numel()
    (out,) = eng.generate(input_ids=[[1, 2, 3, 4, 5]],
                          sampling_params=SamplingParams(max_new_tokens=3, temperature=0.0,
                                                         ignore_eos=True))
    assert len(out["output_ids"]) == 3 and eng.flush_cache()


def test_device_init_params_is_seeded_and_scaled():
    """Deterministic per seed, one stream per leaf, the model's shapes and
    dtype, and 0.02 * N(0, 1) (std within 2%)."""
    cfg = ModelConfig(architecture="LlamaForCausalLM", vocab_size=512, hidden_size=256,
                      intermediate_size=512, num_hidden_layers=2, num_attention_heads=HQ,
                      num_key_value_heads=HKV, head_dim=D, context_length=256,
                      dtype="bfloat16")
    models = [LlamaForCausalLM(cfg, device="cpu") for _ in range(3)]
    for m, seed in zip(models, (5, 5, 6)):
        device_init_params(m, seed)
    a, b, c = (m.params_tree() for m in models)
    jax.tree.map(np.testing.assert_array_equal, a, b)
    assert not np.array_equal(a["lm_head"]["w"], c["lm_head"]["w"])
    for path, shape in models[0].param_specs():
        leaf = models[0].leaf(path)
        assert tuple(leaf.shape) == shape and leaf.dtype == torch.bfloat16
        x = leaf.float()
        assert abs(float(x.std()) - 0.02) < 0.02 * 0.02, path
        assert abs(float(x.mean())) < 0.02 * 0.05, path
    # leaves of one shape draw different numbers; layers of a leaf too
    assert not torch.equal(models[0].input_norm, models[0].post_norm)
    assert not torch.equal(models[0].gate_up[0], models[0].gate_up[1])


# ------------------------------------------------------------------ engine
CFG = dict(architecture="LlamaForCausalLM", vocab_size=512, hidden_size=256,
           intermediate_size=512, num_hidden_layers=L, num_attention_heads=HQ,
           num_key_value_heads=HKV, head_dim=D, max_position_embeddings=512,
           context_length=512, rope_theta=10000.0, dtype="float32")
SERVE = dict(page_size=PS, max_total_tokens=2048, chunked_prefill_size=64)


@pytest.mark.parametrize("kv", ["model_dtype", "fp8_e4m3_scales"])
@pytest.mark.parametrize("semi_pd", [False, True], ids=["colocated", "semi_pd"])
def test_engine_greedy_tokens_match_jax_on_the_aligned_pool(tmp_path, semi_pd, kv):
    """The port's Engine at head_dim 128 (aligned pool) holds the JAX
    Engine's parameters and gives its greedy tokens exactly, with KV in the
    model dtype and with fp8_e4m3 KV plus a per-layer scales file."""
    extra = {}
    if kv == "fp8_e4m3_scales":
        path = tmp_path / "kv_scales.json"
        path.write_text(json.dumps(
            {"kv_cache": {"dtype": "float8_e4m3fn",
                          "scaling_factor": {"0": {"0": 0.05, "1": 0.02}}}}))
        extra = dict(kv_cache_dtype="fp8_e4m3", quantization_param_path=str(path))
    jeng = JaxEngine(server_args=JaxServerArgs(model_path="", random_weights=True,
                                               enable_semi_pd=semi_pd, **SERVE, **extra),
                     model_config=JaxModelConfig(**CFG))
    teng = Engine(ServerArgs(random_weights=True, enable_semi_pd=semi_pd, device="cpu",
                             **SERVE, **extra), ModelConfig(**CFG), device="cpu")
    teng.runner.model.load_jax_params(jax.tree.map(np.asarray, jeng.runner.params))
    buf = teng.runner.kv_cache.buffer
    assert buf.dim() == 5 and buf.dtype == (torch.float8_e4m3fn if extra else torch.float32)
    assert (teng.runner.kv_scales is not None) == bool(extra)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, size=n).tolist() for n in (20, 100, 37)]
    sp = dict(max_new_tokens=6, temperature=0.0, ignore_eos=True)
    jout = jeng.generate(input_ids=prompts, sampling_params=JaxSamplingParams(**sp))
    tout = teng.generate(input_ids=prompts, sampling_params=SamplingParams(**sp),
                         return_logprob=True)
    assert [o["output_ids"] for o in tout] == [o["output_ids"] for o in jout]
    assert all(np.isfinite(o["meta_info"]["output_logprobs"]).all() for o in tout)
    assert teng.flush_cache() and jeng.flush_cache()
