"""The port's DeepSeek-V2 path (MLA over the latent pool, MoE) against the
JAX package on the CPU, with the same numpy inputs:

- the plain MLA decode against the TPU kernel _rpa_kernel_packed's MLA
  branch and the plain MLA extend against _rpa_kernel's MLA branch, both in
  interpret mode, and the plain extend with q_len > 64 against the JAX
  reference attention (the JAX MLA extend leaves rows 64-127 of each
  128-row work-list entry unwritten, ROADMAP C1, so it is no oracle there);
- the latent write + attention of ``paged_attention_mla`` against the JAX
  layer, on an exact and on a lane-padded pool;
- yarn (DeepSeek mscale) + interleaved rope, ``route_topk`` / ``moe_ffn``;
- a tiny DeepSeek-V2 (dense first layer, MoE layers with a shared expert,
  yarn with mscale_all_dim) with and without q_lora, and a tiny V3 (sigmoid
  grouped routing with a score bias): logits against the JAX model, and
  greedy tokens against the JAX Engine, colocated and semi-PD;
- the pool layout rule and the runner's refusals for MLA.

Geometry: Hq 4, latent row kv_lora 128 + rope 64 = 192 (the port's pool is
exactly 192 wide), V = the first 128; the JAX Pallas kernels need a latent
width that is a multiple of 256, so their pool and q are zero-padded to
256 (zeros on both sides leave every score unchanged). Page 16, float32.

Tolerances: attention outputs 2e-5 (float32 both sides: an online softmax
against a full one); MoE 1e-5; logits 1e-4 (float32 through 2-3 layers);
rope tables bit-identical (both computed in float64 numpy), rope outputs
1e-6; the pool after the write bit-identical; greedy tokens identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semi_pd_tpu.config.model_config import ModelConfig as JaxModelConfig
from semi_pd_tpu.config.server_args import ServerArgs as JaxServerArgs
from semi_pd_tpu.layers import attention as jax_attention
from semi_pd_tpu.models.deepseek_v2 import DeepseekV2ForCausalLM as JaxDeepseek
from semi_pd_tpu.ops import moe as jax_moe
from semi_pd_tpu.ops import rope as jax_rope
from semi_pd_tpu.ops.attention.ragged_paged_attention import (
    ragged_paged_attention as jax_rpa,
)
from semi_pd_tpu.ops.attention.reference import (
    ragged_paged_attention_reference as jax_reference,
)
from semi_pd_tpu.ops.attention.rpa_packed import (
    ragged_paged_attention_packed as jax_packed,
)
from semi_pd_tpu.runtime.engine import Engine as JaxEngine
from semi_pd_tpu.runtime.forward_batch import ForwardArrays as JaxFB
from semi_pd_tpu.runtime.forward_batch import build_attn_meta as jax_meta
from semi_pd_tpu.sampling.sampling_params import SamplingParams as JaxSamplingParams

from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.config.server_args import ServerArgs
from semi_pd_tpu_torch.layers.attention import paged_attention_mla, pool_attention
from semi_pd_tpu_torch.model_loader.loader import device_init_params
from semi_pd_tpu_torch.models.deepseek_v2 import DeepseekV2ForCausalLM
from semi_pd_tpu_torch.ops import moe, rope
from semi_pd_tpu_torch.ops.attention import ragged_paged_attention as rpa
from semi_pd_tpu_torch.ops.attention import rpa_packed
from semi_pd_tpu_torch.ops.attention.reference import ragged_paged_attention_reference
from semi_pd_tpu_torch.runtime.batch import build_decode_batch, build_extend_batch
from semi_pd_tpu_torch.runtime.engine import Engine
from semi_pd_tpu_torch.runtime.forward_batch import ForwardArrays, build_attn_meta
from semi_pd_tpu_torch.runtime.model_runner import kv_pool_layout
from semi_pd_tpu_torch.runtime.req import Req
from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams

HQ, LORA, ROPE, PS, L = 4, 128, 64, 16, 2
DLAT, DPAD = LORA + ROPE, 256
SCALE = DLAT ** -0.5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pad(a, width=DPAD):
    return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, width - a.shape[-1])])


def _setup(seed, q_lens, kv_lens, pad_T=0, pad_B=0):
    """Numpy inputs: a latent pool [L, 1, S, 1, DLAT], queries, a shuffled
    page table and the per-request lengths, with optional bucket padding."""
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
    pool = (rng.normal(size=(L, 1, total * PS, 1, DLAT)) * 0.5).astype(np.float32)
    T = sum(q_lens) + pad_T
    q = (rng.normal(size=(T, HQ, DLAT)) * 0.5).astype(np.float32)
    ql = np.zeros(B, np.int64)
    ql[: len(q_lens)] = q_lens
    kl = np.zeros(B, np.int64)
    kl[: len(kv_lens)] = kv_lens
    return dict(q=q, pool=pool, pt=pt, q_lens=ql, kv_lens=kl, T=T)


DECODE_CASES = {
    "ragged_padded_row": ([33, 5, 0, 64, 17, 160, 9], {}),
    "softcap": ([70, 18, 3, 41], {"logit_cap": 5.0}),
    "window": ([70, 18, 3, 41], {"sliding_window": 24}),
}


@pytest.mark.parametrize("rpb", [2, 4])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_mla_decode_plain_matches_jax_packed_kernel(case, rpb):
    """The port's plain MLA decode against _rpa_kernel_packed's MLA branch
    (interpret), both request packings."""
    kv_lens, kw = DECODE_CASES[case]
    B = len(kv_lens)
    d = _setup(3, [1] * B, kv_lens)
    kvl = np.asarray(kv_lens, np.int32)
    ref = np.asarray(jax_packed(
        jnp.asarray(_pad(d["q"])), jnp.asarray(_pad(d["pool"])), 1, jnp.asarray(d["pt"]),
        jnp.asarray(kvl), page_size=PS, scale=SCALE, v_dim=LORA, rpb=rpb, kv_block=64,
        interpret=True, **kw))
    out = rpa_packed.ragged_paged_attention_packed(
        _t(d["q"]), _t(d["pool"]), 1, _t(d["pt"]), _t(kvl), page_size=PS, scale=SCALE,
        v_dim=LORA, **kw).numpy()
    assert out.shape == (B, HQ, LORA)
    live = kvl > 0
    np.testing.assert_allclose(out[live], ref[live], rtol=2e-5, atol=2e-5)
    assert not out[~live].any(), "rows with kv_len == 0 must be zeros"


EXTEND_CASES = {
    # prefix + new tokens, a padded batch row and padded token rows; q_len
    # <= 64 keeps every row inside the rows the JAX MLA extend writes
    "prefix": ([40, 20, 1, 7], [140, 60, 9, 30], {}),
    "softcap": ([40, 64, 7], [90, 130, 57], {"logit_cap": 5.0}),
    "window": ([60, 33, 29], [60, 50, 200], {"sliding_window": 16}),
}


@pytest.mark.parametrize("case", sorted(EXTEND_CASES))
def test_mla_extend_plain_matches_jax_kernel(case):
    """The port's plain MLA extend (routed from ragged_paged_attention with
    v_dim) against _rpa_kernel's MLA branch (interpret) on the same work
    list (q-block 128)."""
    q_lens, kv_lens, kw = EXTEND_CASES[case]
    d = _setup(4, q_lens, kv_lens, pad_T=9, pad_B=1)
    T, kvl = d["T"], d["kv_lens"].astype(np.int32)
    ref = np.asarray(jax_rpa(
        jnp.asarray(_pad(d["q"])), jnp.asarray(_pad(d["pool"])), 1, jnp.asarray(d["pt"]),
        jnp.asarray(kvl), jax_meta(d["q_lens"], d["kv_lens"], T), page_size=PS,
        scale=SCALE, v_dim=LORA, interpret=True, **kw))
    meta = build_attn_meta(d["q_lens"], d["kv_lens"], T)
    out = rpa.ragged_paged_attention(
        _t(d["q"]), _t(d["pool"]), 1, _t(d["pt"]), _t(kvl), meta, page_size=PS,
        scale=SCALE, v_dim=LORA, **kw).numpy()
    n = sum(q_lens)
    np.testing.assert_allclose(out[:n], ref[:n], rtol=2e-5, atol=2e-5)
    assert not out[n:].any(), "bucket-padding rows must stay zero"


@pytest.mark.parametrize("kw", [{}, {"sliding_window": 40}], ids=["causal", "window"])
def test_mla_extend_long_rows_match_jax_reference(kw):
    """q_len 100 and 200 (> 64: rows the JAX MLA extend kernel leaves
    unwritten, and > 128: two work-list entries) against the JAX reference
    attention, the oracle of every kernel."""
    q_lens, kv_lens = [100, 200, 3], [130, 200, 40]
    d = _setup(6, q_lens, kv_lens, pad_T=4)
    T, kvl = d["T"], d["kv_lens"].astype(np.int32)
    qri = np.zeros(T, np.int32)
    qpos = np.zeros(T, np.int32)
    o = 0
    for b, (ql, kl) in enumerate(zip(q_lens, kv_lens)):
        qri[o : o + ql] = b
        qpos[o : o + ql] = np.arange(kl - ql, kl)
        o += ql
    ref = np.asarray(jax_reference(
        jnp.asarray(d["q"]), jnp.asarray(d["pool"]), 1, jnp.asarray(d["pt"]),
        jnp.asarray(qri), jnp.asarray(qpos), jnp.asarray(kvl), page_size=PS, scale=SCALE,
        v_dim=LORA, **kw))
    meta = build_attn_meta(d["q_lens"], d["kv_lens"], T)
    out = rpa.ragged_paged_attention(
        _t(d["q"]), _t(d["pool"]), 1, _t(d["pt"]), _t(kvl), meta, page_size=PS,
        scale=SCALE, v_dim=LORA, **kw).numpy()
    n = sum(q_lens)
    np.testing.assert_allclose(out[:n], ref[:n], rtol=2e-5, atol=2e-5)
    ours_ref = ragged_paged_attention_reference(
        _t(d["q"]), _t(d["pool"]), 1, _t(d["pt"]), _t(qri), _t(qpos), _t(kvl),
        page_size=PS, scale=SCALE, v_dim=LORA, **kw).numpy()
    np.testing.assert_allclose(ours_ref[:n], ref[:n], rtol=2e-5, atol=2e-5)


def test_mla_routing_and_refusals():
    """T == B takes the decode path; the latent pool needs v_dim and only
    it takes one; the latent pool's kernels are refused for other widths
    before any launch."""
    d = _setup(5, [1, 1, 1], [12, 40, 7])
    q, pool, pt = _t(d["q"]), _t(d["pool"]), _t(d["pt"])
    kvl = _t(d["kv_lens"].astype(np.int32))
    meta = build_attn_meta(d["q_lens"], d["kv_lens"], d["T"])
    kw = dict(page_size=PS, scale=SCALE, v_dim=LORA)
    a = rpa.ragged_paged_attention(q, pool, 0, pt, kvl, meta, **kw)
    b = rpa_packed.ragged_paged_attention_packed_plain(q, pool, 0, pt, kvl, **kw)
    e = rpa.ragged_paged_attention_extend_plain(q, pool, 0, pt, kvl, meta, **kw)
    p = pool_attention(pool, plain=True)(q, pool, 0, pt, kvl, meta, **kw)
    assert torch.equal(a, b) and torch.equal(a, p)
    torch.testing.assert_close(a, e, rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="latent pool"):
        rpa.ragged_paged_attention(q, pool, 0, pt, kvl, meta, page_size=PS, scale=SCALE)
    with pytest.raises(ValueError, match="v_dim"):
        rpa.ragged_paged_attention(q, pool, 0, pt, kvl, meta, page_size=PS, scale=SCALE,
                                   v_dim=DLAT + 1)
    from semi_pd_tpu_torch.ops.attention.rpa_common import check_cuda

    with pytest.raises(NotImplementedError, match="ROADMAP B9.4"):
        check_cuda(q, pool, pt, kvl, v_dim=LORA)  # 192 / 128, not 576 / 512


@pytest.mark.parametrize("pool_width", [DLAT, DPAD], ids=["exact", "lane_padded"])
def test_paged_attention_mla_write_and_output_match_jax(pool_width):
    """The latent write at out_slots + attention: the pool after the write
    is bit-identical to the JAX layer's and the output matches within 1e-5,
    on the port's exact pool and on a pool wider than q (zero-padded)."""
    rng = np.random.default_rng(4)
    T, B = 24, 3
    S = 20 * PS
    pool = _pad(rng.normal(size=(L, 1, S, 1, DLAT)).astype(np.float32), pool_width)
    q = rng.normal(size=(T, HQ, DLAT)).astype(np.float32)
    lat = rng.normal(size=(T, DLAT)).astype(np.float32)
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
        attn_meta=jax_meta(qlen, kvl.astype(np.int64), T))
    jout, jpool = jax_attention.paged_attention_mla(
        jnp.asarray(q), jnp.asarray(lat), jnp.asarray(pool), 1, jfb, page_size=PS,
        scale=SCALE, v_dim=LORA)
    fb = ForwardArrays(
        input_ids=None, q_req_idx=_t(qri), q_pos=_t(qpos), out_slots=_t(slots),
        page_table=_t(pt), kv_lens=_t(kvl), logits_idx=None, sampling=None,
        num_reqs=B, attn_meta=build_attn_meta(qlen, kvl, T))
    tpool = _t(pool.copy())
    out = paged_attention_mla(_t(q), _t(lat), tpool, 1, fb, page_size=PS, scale=SCALE,
                              v_dim=LORA)
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))
    assert out.shape == (T, HQ, LORA)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ rope
V2_LITE_YARN = {"type": "yarn", "factor": 40, "original_max_position_embeddings": 4096,
                "beta_fast": 32, "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707}
SMALL_YARN = {"type": "yarn", "factor": 4.0, "original_max_position_embeddings": 64,
              "beta_fast": 32, "beta_slow": 1, "mscale": 1.0, "mscale_all_dim": 0.707}


@pytest.mark.parametrize("neox", [False, True], ids=["interleaved", "neox"])
@pytest.mark.parametrize("scaling", ["v2_lite", "small_mscale_ratio", "plain_yarn"])
def test_yarn_rope_matches_jax(scaling, neox):
    """yarn / DeepSeek-yarn frequencies and mscale, the table's length
    (original_max_position_embeddings x factor: 163840 at V2-Lite) and the
    GPT-J interleaved and NeoX rotations against semi_pd_tpu.ops.rope."""
    rs = {"v2_lite": V2_LITE_YARN, "small_mscale_ratio": SMALL_YARN,
          "plain_yarn": {"rope_type": "yarn", "factor": 8.0,
                         "original_max_position_embeddings": 32}}[scaling]
    ours = rope.RotaryEmbedding(ROPE, rotary_dim=ROPE, max_position=256, theta=10000.0,
                                rope_scaling=rs, is_neox_style=neox)
    theirs = jax_rope.RotaryEmbedding(ROPE, rotary_dim=ROPE, max_position=256,
                                      theta=10000.0, rope_scaling=rs, is_neox_style=neox,
                                      dtype=jnp.float32)
    assert ours.mscale == theirs.mscale
    np.testing.assert_array_equal(ours.cos.numpy(), np.asarray(theirs.cos))
    np.testing.assert_array_equal(ours.sin.numpy(), np.asarray(theirs.sin))
    if scaling == "v2_lite":
        assert tuple(ours.cos.shape) == (163840, ROPE // 2)
    rng = np.random.default_rng(1)
    pos = rng.integers(0, ours.cos.shape[0], size=9).astype(np.int32)
    q = rng.normal(size=(9, HQ, ROPE)).astype(np.float32)
    k = rng.normal(size=(9, 1, ROPE)).astype(np.float32)
    oq, ok = ours(_t(pos), _t(q), _t(k))
    jq, jk = theirs(jnp.asarray(pos), jnp.asarray(q), jnp.asarray(k))
    np.testing.assert_allclose(oq.numpy(), np.asarray(jq), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ok.numpy(), np.asarray(jk), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ moe
ROUTES = {
    # V2 / V2-Lite "greedy": softmax top-k, no renormalisation
    "softmax_greedy": dict(top_k=6, scoring="softmax"),
    # V2 group_limited_greedy: groups scored by their max
    "softmax_group_max": dict(top_k=6, scoring="softmax", n_group=8, topk_group=3,
                              group_score_func="max", routed_scaling_factor=16.0),
    # V3 noaux_tc: sigmoid, score bias, groups by their top-2 sum, renormalised
    "sigmoid_bias_top2": dict(top_k=8, scoring="sigmoid", n_group=8, topk_group=4,
                              group_score_func="top2", norm_topk_prob=True,
                              routed_scaling_factor=2.5, bias=True),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_topk_and_moe_ffn_match_jax(route):
    kw = dict(ROUTES[route])
    top_k = kw.pop("top_k")
    rng = np.random.default_rng(7)
    T, E, d, F = 19, 64, 48, 24
    logits = rng.normal(size=(T, E)).astype(np.float32)
    bias = rng.normal(size=(E,)).astype(np.float32) * 0.1 if kw.pop("bias", False) else None
    w, idx = moe.route_topk(_t(logits), top_k, e_score_bias=None if bias is None else _t(bias),
                            **kw)
    jw, jidx = jax_moe.route_topk(jnp.asarray(logits), top_k,
                                  e_score_bias=None if bias is None else jnp.asarray(bias),
                                  **kw)
    assert w.dtype == torch.float32 and idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)
    x = rng.normal(size=(T, d)).astype(np.float32)
    gate_up = (rng.normal(size=(E, d, 2 * F)) * 0.2).astype(np.float32)
    down = (rng.normal(size=(E, F, d)) * 0.2).astype(np.float32)
    out = moe.moe_ffn(_t(x), _t(gate_up), _t(down), w, idx)
    jout = jax_moe.moe_ffn(jnp.asarray(x), jnp.asarray(gate_up), jnp.asarray(down), jw, jidx)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    # quantized stacks ({"w", "ws"}, the JAX expert_weights' dict form) are
    # served now, in bf16 as JAX serves them (tests/test_torch_quant.py
    # holds them to JAX's moe_ffn); a stack without its scales is refused
    with pytest.raises(KeyError, match="ws"):
        moe.moe_ffn(_t(x), {"w": _t(gate_up)}, _t(down), w, idx)


# ------------------------------------------------------------------ model
def _cfg(variant):
    """A tiny DeepSeek: a dense first layer, then MoE layers with a shared
    expert (8 experts, top-2), the port's latent width 128 + 64, yarn with
    mscale_all_dim; "v2_q_lora" adds the q down-projection, "v3" routes
    with sigmoid groups and a score bias."""
    cfg = dict(architecture="DeepseekV2ForCausalLM", vocab_size=256, hidden_size=128,
               intermediate_size=192, num_hidden_layers=3, num_attention_heads=HQ,
               num_key_value_heads=HQ, head_dim=64 + ROPE, rms_norm_eps=1e-6,
               max_position_embeddings=512, context_length=512, rope_theta=10000.0,
               rope_scaling=dict(SMALL_YARN), use_mla=True, q_lora_rank=None,
               kv_lora_rank=LORA, qk_nope_head_dim=64, qk_rope_head_dim=ROPE,
               v_head_dim=64, num_experts=8, num_experts_per_tok=2,
               moe_intermediate_size=48, num_shared_experts=1, first_k_dense_replace=1,
               topk_method="greedy", dtype="float32")
    if variant == "v2_q_lora":
        cfg["q_lora_rank"] = 96
    if variant == "v3":
        cfg.update(architecture="DeepseekV3ForCausalLM", n_group=4, topk_group=2,
                   topk_method="noaux_tc", norm_topk_prob=True, routed_scaling_factor=2.5,
                   scoring_func="sigmoid", q_lora_rank=96)
    return cfg


def _jax_fb(hb):
    from semi_pd_tpu.ops.sampling import SamplingArrays as JaxSamplingArrays

    return JaxFB(
        input_ids=jnp.asarray(hb.input_ids), q_req_idx=jnp.asarray(hb.q_req_idx),
        q_pos=jnp.asarray(hb.q_pos), out_slots=jnp.asarray(hb.out_slots),
        page_table=jnp.asarray(hb.page_table), kv_lens=jnp.asarray(hb.kv_lens),
        logits_idx=jnp.asarray(hb.logits_idx),
        sampling=JaxSamplingArrays(*[jnp.asarray(a) for a in hb.sampling]),
        rng_key=jax.random.PRNGKey(0), num_reqs=jnp.asarray(len(hb.reqs), jnp.int32),
        attn_meta=jax_meta(hb.q_lens().astype(np.int64), hb.kv_lens.astype(np.int64), hb.T),
    )


@pytest.mark.parametrize("variant", ["v2", "v2_q_lora", "v3"])
def test_deepseek_logits_extend_then_decode_match_jax(variant):
    """Parameters in the JAX tree's order (init_params draws the JAX
    numbers, leaf for leaf), then one extend step (a prompt spanning two
    work-list entries) and two decode steps: logits within 1e-4 of JAX
    DeepseekV2ForCausalLM.forward on its reference attention backend."""
    cfg = _cfg(variant)
    jm = JaxDeepseek(JaxModelConfig(**cfg))
    jm.page_size = PS
    tm = DeepseekV2ForCausalLM(ModelConfig(**cfg), device="cpu")
    tm.page_size = PS
    assert tm.scale == jm.scale
    jparams = jm.init_params(seed=11)
    tm.init_params(seed=11)
    flat, _ = jax.tree_util.tree_flatten_with_path(jparams)
    assert [jax.tree_util.keystr(p) for p, _ in flat] == [
        "".join(f"[{k}]" if k.isdigit() else f"['{k}']" for k in path.split("."))
        for path, _ in tm.param_specs()]
    jax.tree.map(np.testing.assert_array_equal, tm.params_tree(),
                 jax.tree.map(np.asarray, jparams))

    jax_attention.set_attention_backend("reference")
    Lm = cfg["num_hidden_layers"]
    S = 40 * PS
    jpool = jnp.zeros((Lm, 1, S, 1, DLAT), jnp.float32)
    tpool = torch.zeros((Lm, 1, S, 1, DLAT))
    rng = np.random.default_rng(5)
    page_table = np.zeros((4, 16), np.int32)
    reqs = []
    for i, (n, first_page) in enumerate(((150, 1), (37, 20))):
        r = Req(rid=str(i), input_ids=rng.integers(0, 256, size=n).tolist(),
                sampling_params=SamplingParams(temperature=0.0))
        r.req_slot = i
        r.pages = list(range(first_page, first_page + 12))
        page_table[i, :12] = r.pages
        reqs.append(r)
    hb = build_extend_batch([(r, r.prompt_len) for r in reqs], page_table, PS,
                            [256], [4], [16])
    for step in range(3):
        jl, (jpool,) = jm.forward(jparams, _jax_fb(hb), (jpool,))
        tl = tm(hb.to_device("cpu"), tpool)
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2],
                                   rtol=1e-4, atol=1e-4, err_msg=f"step {step}")
        for r, tok in zip(reqs, np.asarray(jl)[:2].argmax(-1)):
            if step == 0:
                r.prefilled_len = r.prompt_len
            r.output_ids.append(int(tok))
        hb = build_decode_batch(reqs, page_table, PS, [4], [16])


def test_device_init_params_draws_per_layer_leaves_whole():
    """The runner's on-device init on the per-layer tree: deterministic per
    seed, every leaf drawn (e_bias kept float32), 0.02 * N(0, 1)."""
    cfg = ModelConfig(**{**_cfg("v3"), "dtype": "bfloat16"})
    a, b = (DeepseekV2ForCausalLM(cfg, device="cpu") for _ in range(2))
    device_init_params(a, 3)
    device_init_params(b, 3)
    for path, shape in a.param_specs():
        x, y = a.leaf(path), b.leaf(path)
        assert tuple(x.shape) == shape and torch.equal(x, y), path
        assert x.dtype == (torch.float32 if path.endswith("e_bias") else torch.bfloat16)
        assert x.float().abs().sum() > 0, path
    big = a.leaf("layers.1.experts.gate_up").float()
    assert abs(float(big.std()) - 0.02) < 0.02 * 0.02
    assert not torch.equal(a.leaf("layers.1.input_norm"), a.leaf("layers.2.input_norm"))


# ------------------------------------------------------------------ engine
SERVE = dict(page_size=PS, max_total_tokens=2048, chunked_prefill_size=64)


@pytest.mark.parametrize("semi_pd", [False, True], ids=["colocated", "semi_pd"])
def test_engine_greedy_tokens_match_jax_on_the_latent_pool(semi_pd):
    """The port's Engine serving the tiny DeepSeek-V2 on its exact 192-wide
    latent pool holds the JAX Engine's parameters (whose pool is padded to
    256) and gives its greedy tokens exactly."""
    cfg = _cfg("v2")
    jeng = JaxEngine(server_args=JaxServerArgs(model_path="", random_weights=True,
                                               enable_semi_pd=semi_pd, **SERVE),
                     model_config=JaxModelConfig(**cfg))
    teng = Engine(ServerArgs(random_weights=True, enable_semi_pd=semi_pd, device="cpu",
                             **SERVE), ModelConfig(**cfg), device="cpu")
    teng.runner.model.load_jax_params(jax.tree.map(np.asarray, jeng.runner.params))
    buf = teng.runner.kv_cache.buffer
    assert tuple(buf.shape[:2]) == (3, 1) and buf.shape[3:] == (1, DLAT)
    assert teng.runner.kv_spec.bytes_total() == buf.numel() * buf.element_size()

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, size=n).tolist() for n in (20, 100, 37)]
    sp = dict(max_new_tokens=6, temperature=0.0, ignore_eos=True)
    jout = jeng.generate(input_ids=prompts, sampling_params=JaxSamplingParams(**sp))
    tout = teng.generate(input_ids=prompts, sampling_params=SamplingParams(**sp),
                         return_logprob=True)
    assert [o["output_ids"] for o in tout] == [o["output_ids"] for o in jout]
    assert all(np.isfinite(o["meta_info"]["output_logprobs"]).all() for o in tout)
    assert teng.flush_cache() and jeng.flush_cache()


# ------------------------------------------------------------------ runner
def test_kv_pool_layout_rule_for_mla():
    """MLA models take the latent pool whatever their latent width (the
    576-wide DeepSeek-V2 row, MiniCPM3's 288, this file's 192); other
    geometries keep their rule."""
    for width in (576, 288, DLAT):
        assert kv_pool_layout(1, width, use_mla=True) == "latent"
    assert kv_pool_layout(8, 128) == "aligned" and kv_pool_layout(8, 64) == "chunked"


@pytest.mark.parametrize("extra", [{"kv_cache_dtype": "fp8_e4m3"},
                                   {"quantization_param_path": "scales.json"}],
                         ids=["fp8_latent_kv", "kv_scales"])
def test_runner_refuses_fp8_and_scales_for_mla(extra):
    """fp8 latent rows are served (the latent pool in the fp8 dtype, as the
    JAX runner sizes it); per-layer KV scales stay refused, as the JAX
    runner refuses them: the latent pool holds K and V in one row."""
    if "quantization_param_path" in extra:
        with pytest.raises(ValueError, match="MLA models"):
            Engine(ServerArgs(random_weights=True, device="cpu", **SERVE, **extra),
                   ModelConfig(**_cfg("v2")), device="cpu")
        return
    eng = Engine(ServerArgs(random_weights=True, device="cpu", **SERVE, **extra),
                 ModelConfig(**_cfg("v2")), device="cpu")
    buf = eng.runner.kv_cache.buffer
    assert buf.dtype == torch.float8_e4m3fn and buf.shape[-1] == DLAT
    assert eng.runner.kv_spec.bytes_total() == buf.numel()
    (out,) = eng.generate(input_ids=[[3, 1, 4, 1, 5, 9, 2, 6]],
                          sampling_params=SamplingParams(max_new_tokens=3, temperature=0.0,
                                                         ignore_eos=True))
    assert len(out["output_ids"]) == 3 and eng.flush_cache()
