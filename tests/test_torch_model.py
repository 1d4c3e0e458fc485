"""Port layers and model (semi_pd_tpu_torch) against the JAX package on the
CPU, with the same numpy inputs: elementwise ops, RoPE, sampling, the
attention layer's pool write, parameter init / loading, and the logits of
one extend step and two decode steps.

Test model: 2 layers, hidden 256, intermediate 512, Hq 8, Hkv 2, D 64,
vocab 512, page 16, float32. The JAX runner's layout rule puts Hkv 2 on the
5D pool (the merged kernels' path) and Hkv 8 on the chunked pool (a slot
row of 8 chunks of 128); the layer and logits twins run both.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semi_pd_tpu.config.model_config import ModelConfig as JaxModelConfig
from semi_pd_tpu.layers import attention as jax_attention
from semi_pd_tpu.models.llama import LlamaForCausalLM as JaxLlama
from semi_pd_tpu.ops import elementwise as jax_elem
from semi_pd_tpu.ops import rope as jax_rope
from semi_pd_tpu.ops import sampling as jax_sampling
from semi_pd_tpu.ops.sampling import SamplingArrays as JaxSamplingArrays
from semi_pd_tpu.runtime.forward_batch import ForwardArrays as JaxFB
from semi_pd_tpu.runtime.forward_batch import build_attn_meta as jax_meta

from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.layers.attention import paged_attention
from semi_pd_tpu_torch.models.llama import LlamaForCausalLM
from semi_pd_tpu_torch.ops import elementwise, rope, sampling
from semi_pd_tpu_torch.ops.sampling import SamplingArrays
from semi_pd_tpu_torch.runtime.batch import build_decode_batch, build_extend_batch
from semi_pd_tpu_torch.runtime.model_runner import kv_pool_layout
from semi_pd_tpu_torch.runtime.req import Req
from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams

PS = 16
CFG = dict(architecture="LlamaForCausalLM", vocab_size=512, hidden_size=256,
           intermediate_size=512, num_hidden_layers=2, num_attention_heads=8,
           num_key_value_heads=2, head_dim=64, max_position_embeddings=512,
           context_length=512, rope_theta=10000.0, dtype="float32")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_fb(hb):
    """JAX ForwardArrays from the numpy arrays of a port HostBatch."""
    B = hb.B
    return JaxFB(
        input_ids=jnp.asarray(hb.input_ids), q_req_idx=jnp.asarray(hb.q_req_idx),
        q_pos=jnp.asarray(hb.q_pos), out_slots=jnp.asarray(hb.out_slots),
        page_table=jnp.asarray(hb.page_table), kv_lens=jnp.asarray(hb.kv_lens),
        logits_idx=jnp.asarray(hb.logits_idx),
        sampling=JaxSamplingArrays(*[jnp.asarray(a) for a in hb.sampling]),
        rng_key=jax.random.PRNGKey(0), num_reqs=jnp.asarray(len(hb.reqs), jnp.int32),
        attn_meta=jax_meta(hb.q_lens().astype(np.int64), hb.kv_lens.astype(np.int64), hb.T),
    )


# ------------------------------------------------------------------ ops
def test_elementwise_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(7, 256)).astype(np.float32)
    r = rng.normal(size=(7, 256)).astype(np.float32)
    w = rng.normal(size=(256,)).astype(np.float32)
    np.testing.assert_allclose(
        elementwise.rms_norm(_t(x), _t(w), 1e-6).numpy(),
        np.asarray(jax_elem.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)),
        rtol=1e-5, atol=1e-6)
    a, b = elementwise.fused_add_rms_norm(_t(x), _t(r), _t(w))
    ja, jb = jax_elem.fused_add_rms_norm(jnp.asarray(x), jnp.asarray(r), jnp.asarray(w))
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-6)
    g = rng.normal(size=(7, 512)).astype(np.float32)
    np.testing.assert_allclose(
        elementwise.silu_and_mul(_t(g)).numpy(),
        np.asarray(jax_elem.silu_and_mul(jnp.asarray(g))), rtol=1e-5, atol=1e-6)


ROPE_CASES = {
    "default": dict(theta=10000.0, rope_scaling=None),
    "llama3": dict(theta=500000.0, rope_scaling={
        "rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
        "high_freq_factor": 4.0, "original_max_position_embeddings": 64}),
}


@pytest.mark.parametrize("case", sorted(ROPE_CASES))
def test_rope_matches_jax(case):
    kw = ROPE_CASES[case]
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 512, size=9).astype(np.int32)
    q = rng.normal(size=(9, 8, 64)).astype(np.float32)
    k = rng.normal(size=(9, 2, 64)).astype(np.float32)
    ours = rope.RotaryEmbedding(64, max_position=512, **kw)
    theirs = jax_rope.RotaryEmbedding(64, max_position=512, dtype=jnp.float32, **kw)
    oq, ok = ours(_t(pos), _t(q), _t(k))
    jq, jk = theirs(jnp.asarray(pos), jnp.asarray(q), jnp.asarray(k))
    np.testing.assert_allclose(oq.numpy(), np.asarray(jq), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ok.numpy(), np.asarray(jk), rtol=1e-5, atol=1e-5)


def _sampling_arrays(B, temperature, top_k, top_p, min_p):
    z = np.zeros(B, np.float32)
    return [np.full(B, temperature, np.float32), np.full(B, top_k, np.int32),
            np.full(B, top_p, np.float32), np.full(B, min_p, np.float32), z, z,
            np.ones(B, np.float32)]


def test_greedy_sampling_and_logprobs_match_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(6, 512)).astype(np.float32) * 3
    arrs = _sampling_arrays(6, 0.0, 0, 1.0, 0.0)
    g = torch.Generator().manual_seed(0)
    for all_greedy in (False, True):
        ours = sampling.sample(_t(logits), SamplingArrays(*[_t(a) for a in arrs]), g,
                               all_greedy=all_greedy)
        theirs = jax_sampling.sample(jnp.asarray(logits),
                                     JaxSamplingArrays(*[jnp.asarray(a) for a in arrs]),
                                     jax.random.PRNGKey(0))
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    lp = sampling.compute_logprobs(_t(logits), ours)
    jlp = jax_sampling.compute_logprobs(jnp.asarray(logits), jnp.asarray(ours.numpy()))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("filt", ["top_k", "top_p", "min_p"])
def test_sampling_filters_keep_the_jax_support(filt):
    """Sampled tokens land inside the set the JAX sampler keeps (the draws
    themselves cannot match: torch.Generator is not jax.random)."""
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(4, 512)).astype(np.float32) * 2
    kw = {"top_k": (1.0, 5, 1.0, 0.0), "top_p": (1.0, 0, 0.5, 0.0),
          "min_p": (1.0, 0, 1.0, 0.3)}[filt]
    arrs = _sampling_arrays(4, *kw)
    sorted_desc = np.sort(logits, axis=-1)[:, ::-1]

    def in_support(b, t):  # the JAX sampler's thresholds, recomputed
        if filt == "top_k":
            return logits[b, t] >= sorted_desc[b, 4]
        if filt == "top_p":
            p = np.exp(sorted_desc[b] - sorted_desc[b].max())
            p /= p.sum()
            return logits[b, t] >= sorted_desc[b, np.argmax(np.cumsum(p) >= 0.5)]
        p = np.exp(logits[b] - logits[b].max())
        return p[t] >= 0.3 * p.max()

    jarr = JaxSamplingArrays(*[jnp.asarray(a) for a in arrs])
    g = torch.Generator().manual_seed(0)
    for s in range(30):
        jt = np.asarray(jax_sampling.sample(jnp.asarray(logits), jarr, jax.random.PRNGKey(s)))
        tt = sampling.sample(_t(logits), SamplingArrays(*[_t(a) for a in arrs]), g).numpy()
        for b in range(4):
            assert in_support(b, int(jt[b])) and in_support(b, int(tt[b]))


# ------------------------------------------------------------------ layer
@pytest.mark.parametrize("layout", ["chunked", "5d"])
def test_paged_attention_layer_matches_jax(layout):
    """KV write + attention on the chunked pool [L, S, CT, 128] and on the
    5D pool [L, 2, S, Hkv, 64]: the pool after the write is identical to
    the JAX layer's and the output matches within 1e-5."""
    rng = np.random.default_rng(4)
    T, B, Hq, Hkv, D, Lp = 24, 3, 8, 2, 64, 2
    S = 20 * PS
    shape = ((Lp, S, 2 * Hkv * D // 128, 128) if layout == "chunked"
             else (Lp, 2, S, Hkv, D))
    pool = rng.normal(size=shape).astype(np.float32)
    q = rng.normal(size=(T, Hq, D)).astype(np.float32)
    k = rng.normal(size=(T, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(T, Hkv, D)).astype(np.float32)
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
        attn_meta=jax_meta(qlen, kvl.astype(np.int64), T))
    jout, jpool = jax_attention.paged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pool), 1, jfb,
        page_size=PS, scale=0.125)

    from semi_pd_tpu_torch.runtime.forward_batch import ForwardArrays, build_attn_meta

    fb = ForwardArrays(
        input_ids=None, q_req_idx=_t(qri), q_pos=_t(qpos), out_slots=_t(slots),
        page_table=_t(pt), kv_lens=_t(kvl), logits_idx=None, sampling=None,
        num_reqs=B, attn_meta=build_attn_meta(qlen, kvl, T))
    tpool = _t(pool.copy())
    out = paged_attention(_t(q), _t(k), _t(v), tpool, 1, fb, page_size=PS, scale=0.125)
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ model
@pytest.fixture(scope="module")
def models():
    jm = JaxLlama(JaxModelConfig(**CFG))
    jm.page_size = PS
    tm = LlamaForCausalLM(ModelConfig(**CFG), device="cpu")
    tm.page_size = PS
    return jm, tm


def test_init_params_match_jax_leaf_for_leaf(models):
    jm, tm = models
    jparams = jm.init_params(seed=7)
    tm.init_params(seed=7)
    ours = tm.params_tree()
    flat, _ = jax.tree_util.tree_flatten_with_path(jparams)
    assert [jax.tree_util.keystr(p) for p, _ in flat] == [
        "".join(f"['{k}']" for k in path.split(".")) for path, _ in tm.param_specs()]
    for path, leaf in flat:
        node = ours
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))


def test_load_jax_params_round_trips(models):
    jm, tm = models
    tree = jax.tree.map(np.asarray, jm.init_params(seed=3))
    tm.load_jax_params(tree)
    back = tm.params_tree()
    jax.tree.map(np.testing.assert_array_equal, back, tree)
    with pytest.raises(ValueError, match="shape"):
        bad = jax.tree.map(np.asarray, jm.init_params(seed=3))
        bad["final_norm"] = bad["final_norm"][:-1]
        tm.load_jax_params(bad)


@pytest.mark.parametrize("num_kv_heads,layout", [(8, "chunked"), (2, "5d")])
def test_logits_extend_then_decode_match_jax(num_kv_heads, layout):
    """One extend step (two prompts, one spanning two work-list blocks) and
    two decode steps on the pool the layout rule gives the geometry: the
    port's logits match JAX LlamaForCausalLM.forward within 1e-4."""
    cfg = dict(CFG, num_key_value_heads=num_kv_heads)
    jm = JaxLlama(JaxModelConfig(**cfg))
    jm.page_size = PS
    tm = LlamaForCausalLM(ModelConfig(**cfg), device="cpu")
    tm.page_size = PS
    assert kv_pool_layout(num_kv_heads, 64) == {"chunked": "chunked", "5d": "aligned"}[layout]
    jparams = jm.init_params(seed=11)
    tm.load_jax_params(jax.tree.map(np.asarray, jparams))
    jax_attention.set_attention_backend("reference")
    L = CFG["num_hidden_layers"]
    S = 40 * PS
    # the JAX reference-backend pool, and the port's pool of the layout rule
    jpool = jnp.zeros((L, 2, S, num_kv_heads, 64), jnp.float32)
    tpool = (torch.zeros((L, S, 2 * num_kv_heads * 64 // 128, 128)) if layout == "chunked"
             else torch.zeros((L, 2, S, num_kv_heads, 64)))
    rng = np.random.default_rng(5)
    page_table = np.zeros((4, 16), np.int32)
    reqs = []
    for i, (n, first_page) in enumerate(((150, 1), (37, 20))):
        r = Req(rid=str(i), input_ids=rng.integers(0, 512, size=n).tolist(),
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
