"""The Llama-family strings and Gemma-1 of the port against the JAX package
on the CPU, with the same numpy inputs:

- Mistral (a sliding window of 8 that the prompts pass), Xverse, Qwen2
  (the qkv bias its ``Qwen*`` string turns on), Qwen3 (per-head q/k
  norms) and Gemma-1 (head_dim 256, (1 + w) norms, the scaled embedding,
  GeGLU, tied) at tiny widths, each config a HuggingFace dict read by both
  packages' ``ModelConfig.from_hf_config``: the parameter tree leaf for
  leaf against the JAX ``param_specs`` and ``init_params(seed)``, the
  float32 logits of an extend step and two decode steps within 1e-4 of the
  JAX model's ``forward``, and the Engine's greedy tokens equal to the JAX
  Engine's, colocated and semi-PD;
- ``from_hf_config`` against the JAX one, field for field, on the
  published config.json of the seven models ``chip_smoke.py`` runs
  (``chip_smoke.PUBLISHED``), and the refusal of an unserved architecture;
- the plain decode, stream and extend at one query head per KV head (Hq =
  Hkv, Qwen1.5-MoE's, OLMoE's and Gemma-7B's heads) on the 5D pool at
  head_dim 128 and 256, against the TPU kernels' GQA branches in interpret
  mode: what the aligned builds and their ``_256`` twins are held to on
  the card at G = 1.

The MoE families are in tests/test_torch_moe_families.py, which reuses
this file's helpers.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semi_pd_tpu.config.model_config import ModelConfig as JaxModelConfig
from semi_pd_tpu.config.server_args import ServerArgs as JaxServerArgs
from semi_pd_tpu.models.registry import create_model as jax_create_model
from semi_pd_tpu.ops.attention.ragged_paged_attention import (
    ragged_paged_attention as jax_rpa,
)
from semi_pd_tpu.ops.attention.rpa_packed import (
    ragged_paged_attention_packed as jax_packed,
)
from semi_pd_tpu.ops.sampling import SamplingArrays as JaxSamplingArrays
from semi_pd_tpu.runtime.engine import Engine as JaxEngine
from semi_pd_tpu.runtime.forward_batch import ForwardArrays as JaxFB
from semi_pd_tpu.runtime.forward_batch import build_attn_meta as jax_meta
from semi_pd_tpu.sampling.sampling_params import SamplingParams as JaxSamplingParams

import chip_smoke
from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.config.server_args import ServerArgs
from semi_pd_tpu_torch.models.gemma2 import GemmaForCausalLM
from semi_pd_tpu_torch.models.llama import LlamaForCausalLM
from semi_pd_tpu_torch.ops.attention import ragged_paged_attention as rpa
from semi_pd_tpu_torch.ops.attention import rpa_packed
from semi_pd_tpu_torch.runtime.batch import build_decode_batch, build_extend_batch
from semi_pd_tpu_torch.runtime.engine import Engine
from semi_pd_tpu_torch.runtime.forward_batch import build_attn_meta
from semi_pd_tpu_torch.runtime.model_runner import ARCHITECTURES
from semi_pd_tpu_torch.runtime.req import Req
from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams

PS = 16
VOCAB = 128


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------------ configs
def hf_config(arch, **kw):
    """A tiny HF config.json dict of ``arch``: 2 layers, hidden 64, head_dim
    128 (the aligned pool), vocab 128, context 256; ``kw`` adds or
    overrides keys."""
    return {**dict(architectures=[arch], vocab_size=VOCAB, hidden_size=64,
                   intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2, head_dim=128, max_position_embeddings=256,
                   rope_theta=10000.0, rms_norm_eps=1e-6, hidden_act="silu",
                   tie_word_embeddings=False), **kw}


# the five strings: Mistral's window cuts the 40- and 70-token prompts,
# Qwen2's config leaves attention_bias out (its string turns the bias on)
# and is multi-head, as Qwen1.5-MoE is; Gemma-1 multi-head at head_dim 256,
# as Gemma-7B
FAMILIES = {
    "mistral": hf_config("MistralForCausalLM", sliding_window=8),
    "xverse": hf_config("XverseForCausalLM"),
    "qwen2": hf_config("Qwen2ForCausalLM", num_key_value_heads=4, rope_theta=1000000.0),
    "qwen3": hf_config("Qwen3ForCausalLM", attention_bias=False, rope_theta=1000000.0),
    "gemma": hf_config("GemmaForCausalLM", head_dim=256, num_key_value_heads=4,
                       hidden_act="gelu", tie_word_embeddings=True),
}


def both_configs(hf, **kw):
    """(JAX ModelConfig, port ModelConfig) of the HF dict ``hf`` in float32
    (the JAX package reads it as attributes), ``kw`` set on both."""
    jcfg = JaxModelConfig.from_hf_config(types.SimpleNamespace(**hf), dtype="float32")
    tcfg = ModelConfig.from_hf_config(hf, dtype="float32")
    for k, v in kw.items():
        setattr(jcfg, k, v)
        setattr(tcfg, k, v)
    return jcfg, tcfg


def jax_paths(tree):
    return [".".join(str(getattr(k, "key", k)) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


# --------------------------------------------------------------- the model
def _jax_fb(hb):
    return JaxFB(
        input_ids=jnp.asarray(hb.input_ids), q_req_idx=jnp.asarray(hb.q_req_idx),
        q_pos=jnp.asarray(hb.q_pos), out_slots=jnp.asarray(hb.out_slots),
        page_table=jnp.asarray(hb.page_table), kv_lens=jnp.asarray(hb.kv_lens),
        logits_idx=jnp.asarray(hb.logits_idx),
        sampling=JaxSamplingArrays(*[jnp.asarray(a) for a in hb.sampling]),
        rng_key=jax.random.PRNGKey(0), num_reqs=jnp.asarray(len(hb.reqs), jnp.int32),
        attn_meta=jax_meta(hb.q_lens().astype(np.int64), hb.kv_lens.astype(np.int64), hb.T),
    )


def check_params_match_jax(hf, cls, seed=7):
    """The port's model of ``hf`` has the JAX model's leaves, paths and
    shapes in the JAX tree's order, and ``init_params(seed)`` draws the JAX
    numbers; returns (JAX model, its params, port model)."""
    jcfg, tcfg = both_configs(hf)
    jm = jax_create_model(jcfg)
    tm = ARCHITECTURES[tcfg.architecture](tcfg, device="cpu")
    assert type(tm) is cls
    jparams = jm.init_params(seed=seed)
    assert [p for p, _ in tm.param_specs()] == jax_paths(jparams)
    assert [s for _, s in tm.param_specs()] == [
        x.shape for x in jax.tree_util.tree_leaves(jparams)]
    tm.init_params(seed=seed)
    jax.tree.map(np.testing.assert_array_equal, tm.params_tree(),
                 jax.tree.map(np.asarray, jparams))
    return jm, jparams, tm


def check_logits_match_jax(jm, jparams, tm, lens=(70, 40), tol=1e-4):
    """One extend step (prompts of ``lens`` tokens) and two decode steps of
    the port's model and the JAX model's ``forward`` on twin 5D pools:
    float32 logits within ``tol``; returns the largest logit seen."""
    jm.page_size = tm.page_size = PS
    c = tm.config
    L, Hkv, D = c.num_hidden_layers, c.num_key_value_heads, c.head_dim
    S = 24 * PS
    jpool = jnp.zeros((L, 2, S, Hkv, D), jnp.float32)
    tpool = torch.zeros((L, 2, S, Hkv, D))
    rng = np.random.default_rng(5)
    page_table = np.zeros((4, 12), np.int32)
    reqs = []
    for i, n in enumerate(lens):
        r = Req(rid=str(i), input_ids=rng.integers(0, c.vocab_size, size=n).tolist(),
                sampling_params=SamplingParams(temperature=0.0))
        r.req_slot = i
        r.pages = list(range(1 + 11 * i, 12 + 11 * i))
        page_table[i, :11] = r.pages
        reqs.append(r)
    hb = build_extend_batch([(r, r.prompt_len) for r in reqs], page_table, PS,
                            [256], [4], [12])
    big = 0.0
    forward = jax.jit(jm.forward)  # two programs: the extend's and the decodes'
    for step in range(3):
        jl, (jpool,) = forward(jparams, _jax_fb(hb), (jpool,))
        tl = tm(hb.to_device("cpu"), tpool)
        n = len(reqs)
        np.testing.assert_allclose(tl.numpy()[:n], np.asarray(jl)[:n], rtol=tol, atol=tol,
                                   err_msg=f"step {step}")
        big = max(big, float(np.abs(np.asarray(jl)[:n]).max()))
        for r, tok in zip(reqs, np.asarray(jl)[:n].argmax(-1)):
            if step == 0:
                r.prefilled_len = r.prompt_len
            r.output_ids.append(int(tok))
        hb = build_decode_batch(reqs, page_table, PS, [4], [12])
    return big


CLASSES = {"mistral": LlamaForCausalLM, "xverse": LlamaForCausalLM,
           "qwen2": LlamaForCausalLM, "qwen3": LlamaForCausalLM, "gemma": GemmaForCausalLM}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_params_and_logits_match_jax(family):
    """Each string's model draws the JAX parameters leaf for leaf (Qwen2's
    ``layers.qkv_proj.b`` and Qwen3's ``layers.q_norm`` / ``k_norm``
    [L, head_dim] in the JAX order; Gemma's tied tree) and gives the JAX
    model's float32 logits within 1e-4 over an extend step and two decode
    steps; the family's own leaves are read (scaled up, they move the
    logits)."""
    hf = FAMILIES[family]
    jm, jparams, tm = check_params_match_jax(hf, CLASSES[family])
    paths = [p for p, _ in tm.param_specs()]
    assert ("layers.qkv_proj.b" in paths) == (family == "qwen2")
    assert ("layers.q_norm" in paths) == ("layers.k_norm" in paths) == (family == "qwen3")
    if family == "qwen3":
        assert dict(tm.param_specs())["layers.q_norm"] == (2, 128)
    if family == "gemma":
        assert tm.lm_head is None and "lm_head.w" not in paths
        assert tm.scale == jm.scale == 256 ** -0.5
        assert tm.embed_scale == float(np.float32(8.0))
    assert tm.layer_windows == [hf.get("sliding_window")] * 2
    # the family's leaves at a size that shows: the bias, the q/k norms at
    # 1 + w (the random 0.02 N(0, 1) shrinks the scores 2500-fold)
    for path in ("layers.qkv_proj.b", "layers.q_norm", "layers.k_norm"):
        if path in paths:
            tm.leaf(path).add_(1.0)
            keys = path.split(".")
            node = jparams
            for k in keys[:-1]:
                node = node[k]
            node[keys[-1]] = node[keys[-1]] + 1.0
    check_logits_match_jax(jm, jparams, tm)


SERVE = dict(page_size=16, max_total_tokens=1024, chunked_prefill_size=64, decode_bs_buckets=[4])


def engine_pair(hf):
    """A JAX Engine and the port's Engine on its parameters, float32, both
    on their CPU paths."""
    jcfg, tcfg = both_configs(hf)
    jeng = JaxEngine(server_args=JaxServerArgs(model_path="", random_weights=True,
                                               dtype="float32", **SERVE),
                     model_config=jcfg)
    teng = Engine(ServerArgs(random_weights=True, device="cpu", **SERVE), tcfg, device="cpu")
    teng.runner.model.load_jax_params(jax.tree.map(np.asarray, jeng.runner.params))
    return jeng, teng


@pytest.fixture(scope="module")
def engines():
    """One engine pair per config, shared by a module's tests (the JAX
    Engine's compiled programs are most of a test's time); each serve gets
    fresh schedulers."""
    cache = {}

    def get(name, hf):
        if name not in cache:
            cache[name] = engine_pair(hf)
        return cache[name]

    yield get
    cache.clear()


def check_engine_matches_jax(pair, semi_pd, prompts_lens=(9, 17, 70), max_new=6):
    """Fresh schedulers on both engines of ``pair``, colocated or semi-PD:
    the port's greedy tokens equal the JAX Engine's exactly."""
    from semi_pd_tpu.runtime.scheduler import Scheduler as JaxScheduler

    from semi_pd_tpu_torch.runtime.scheduler import Scheduler

    for eng, sched in zip(pair, (JaxScheduler, Scheduler)):
        assert eng.flush_cache()
        args = dataclasses.replace(eng.server_args, enable_semi_pd=semi_pd)
        eng.server_args, eng.scheduler = args, sched(args, eng.runner)
    jeng, teng = pair
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, VOCAB, size=n).tolist() for n in prompts_lens]
    sp = dict(max_new_tokens=max_new, temperature=0.0, ignore_eos=True)
    jout = jeng.generate(input_ids=prompts, sampling_params=JaxSamplingParams(**sp))
    tout = teng.generate(input_ids=prompts, sampling_params=SamplingParams(**sp))
    assert [o["output_ids"] for o in tout] == [o["output_ids"] for o in jout]
    assert teng.flush_cache() and jeng.flush_cache()


@pytest.mark.parametrize("semi_pd", [False, True], ids=["colocated", "semi_pd"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_engine_greedy_tokens_match_jax(family, semi_pd, engines):
    """Each string served by the port's Engine on the JAX Engine's weights
    gives the JAX Engine's greedy tokens, colocated and semi-PD; the 5D
    pool at the family's head_dim (Gemma-1's 256: the _256 builds' pool)."""
    pair = engines(family, FAMILIES[family])
    check_engine_matches_jax(pair, semi_pd)
    buf = pair[1].runner.kv_cache.buffer
    assert buf.shape[1] == 2 and buf.shape[-1] == FAMILIES[family]["head_dim"]


# ------------------------------------------------------- from_hf_config
# the JAX ModelConfig's fields the port's shares (all the port's but the
# four that the JAX models read from hf_config: checked through the models;
# and hf_config itself, the config as each package was given it: a
# namespace on the JAX side, the dict on the port's)
READ_BY_MODEL = {"query_pre_attn_scalar", "scale_emb", "scale_depth", "dim_model_base",
                 "hf_config"}


def shared_fields():
    jax_fields = {f.name for f in dataclasses.fields(JaxModelConfig)}
    return [f.name for f in dataclasses.fields(ModelConfig)
            if f.name in jax_fields and f.name not in READ_BY_MODEL]


@pytest.mark.parametrize("repo", list(chip_smoke.PUBLISHED))
def test_from_hf_config_matches_jax_on_published_configs(repo):
    """The port's ModelConfig.from_hf_config of each published config.json
    equals the JAX one field for field (the JAX one reads it as attributes);
    what the JAX model sets when it is built (Qwen2-MoE's shared expert,
    Qwen3-MoE's bias off, Gemma's softcaps off, scale and tied head) the
    port's model has as well."""
    hf = chip_smoke.PUBLISHED[repo]
    jcfg = JaxModelConfig.from_hf_config(types.SimpleNamespace(**hf), context_length=8192)
    tcfg = ModelConfig.from_hf_config(hf, context_length=8192)
    fields = shared_fields()
    assert len(fields) >= 40
    got = {f: getattr(tcfg, f) for f in fields}
    want = {f: getattr(jcfg, f) for f in fields}
    # the JAX package's Qwen2-MoE reads its shared expert when it is built
    if hf["architectures"][0] == "Qwen2MoeForCausalLM":
        want["num_shared_experts"] = jax_create_model(jcfg).config.num_shared_experts
        assert want["num_shared_experts"] == 4  # 5632 // 1408
    assert got == want
    # the classes' own settings, on a config cut to one layer
    jm = jax_create_model(dataclasses.replace(jcfg, num_hidden_layers=1))
    tm = ARCHITECTURES[tcfg.architecture](dataclasses.replace(tcfg, num_hidden_layers=1),
                                          device="meta")
    for f in ("attention_bias", "tie_word_embeddings", "attn_logit_softcap",
              "logit_softcap", "num_shared_experts", "sliding_window"):
        assert getattr(tm.config, f) == getattr(jm.config, f), f
    assert tm.scale == jm.scale
    assert [p for p, _ in tm.param_specs()] == jax_paths(jm.param_specs())


def test_published_configs_read_as_documented():
    """The seven configs read as the models publish them: Qwen1.5-MoE's
    window of 32768 is taken although use_sliding_window is false (the JAX
    rule), Qwen3's bias stays off, Mixtral's experts come from
    num_local_experts; an unserved architecture is refused naming A14."""
    P = chip_smoke.PUBLISHED
    moe = ModelConfig.from_hf_config(P["Qwen/Qwen1.5-MoE-A2.7B"])
    assert moe.sliding_window == 32768 and moe.num_shared_experts == 4
    assert (moe.num_experts, moe.num_experts_per_tok, moe.moe_intermediate_size) == (60, 4, 1408)
    q3 = ModelConfig.from_hf_config(P["Qwen/Qwen3-8B"])
    assert not q3.attention_bias and q3.head_dim == 128 and q3.rope_theta == 1000000
    assert ModelConfig.from_hf_config(hf_config("Qwen2ForCausalLM")).attention_bias
    mix = ModelConfig.from_hf_config(P["mistralai/Mixtral-8x7B-v0.1"])
    assert (mix.num_experts, mix.moe_intermediate_size) == (8, 14336)
    gem = ModelConfig.from_hf_config(P["google/gemma-7b"])
    assert gem.head_dim == 256 and gem.query_pre_attn_scalar is None
    with pytest.raises(NotImplementedError, match="ROADMAP A14"):
        ModelConfig.from_hf_config(hf_config("MllamaForConditionalGeneration"))


# --------------------------------------- the plain attention at G = 1
HEADS = 4  # Hq = Hkv
PAIRS = {"float32": (np.float32, torch.float32, 2e-5),
         "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-2)}


def _setup(seed, q_lens, kv_lens, D, dtype, pad_T=0, pad_B=0):
    """A one-layer 5D pool [1, 2, S, 4, D] and queries [T, 4, D] in
    ``dtype`` (Hq = Hkv), a shuffled page table and the lengths."""
    np_t, torch_t, _ = PAIRS[dtype]
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
    pool = (rng.normal(size=(1, 2, total * PS, HEADS, D)) * 0.5).astype(np.float32)
    T = sum(q_lens) + pad_T
    q = rng.normal(size=(T, HEADS, D)).astype(np.float32)
    ql = np.zeros(B, np.int64)
    ql[: len(q_lens)] = q_lens
    kl = np.zeros(B, np.int64)
    kl[: len(kv_lens)] = kv_lens
    return dict(jq=jnp.asarray(q, np_t), tq=_t(q).to(torch_t),
                jpool=jnp.asarray(pool, np_t), tpool=_t(pool).to(torch_t), pt=pt,
                q_lens=ql, kv_lens=kl, T=T)


def _close(out, ref, rows, tol):
    np.testing.assert_allclose(out.float().numpy()[rows],
                               np.asarray(jnp.asarray(ref, jnp.float32))[rows],
                               rtol=tol, atol=tol)


CASES = [(D, kind, dt) for D in (128, 256) for kind in ("decode", "stream", "extend")
         for dt in PAIRS]


@pytest.mark.parametrize("D,kind,dtype", CASES, ids=[f"{k}-D{d}-{t}" for d, k, t in CASES])
def test_plain_attention_at_one_query_head_per_kv_head(D, kind, dtype, monkeypatch):
    """The port's plain decode, stream and extend with Hq = Hkv = 4 on the 5D
    pool at head_dim 128 / 256 against _rpa_kernel_packed, _rpa_kernel_stream
    (RPA_DECODE_STREAM=1 on the JAX call only) and _rpa_kernel in
    interpret mode; a padded decode row (kv_len 0) gives zeros, the
    extend's padding rows too."""
    scale = D ** -0.5
    tol = PAIRS[dtype][2]
    if kind == "extend":
        q_lens, kv_lens = [20, 1, 7], [60, 9, 30]
        d = _setup(4, q_lens, kv_lens, D, dtype, pad_T=5, pad_B=1)
    else:
        q_lens, kv_lens = [1] * 4, [33, 0, 64, 17]
        d = _setup(3, q_lens, kv_lens, D, dtype)
    T, kvl = d["T"], d["kv_lens"].astype(np.int32)
    jmeta = jax_meta(d["q_lens"], d["kv_lens"], T)
    meta = build_attn_meta(d["q_lens"], d["kv_lens"], T)
    if kind == "decode":
        ref = jax_packed(d["jq"], d["jpool"], 0, jnp.asarray(d["pt"]), jnp.asarray(kvl),
                         page_size=PS, scale=scale, rpb=2, kv_block=32, interpret=True)
        out = rpa_packed.ragged_paged_attention_packed(
            d["tq"], d["tpool"], 0, _t(d["pt"]), _t(kvl), page_size=PS, scale=scale)
    elif kind == "stream":
        with monkeypatch.context() as m:
            m.setenv("RPA_DECODE_STREAM", "1")
            m.setenv("RPA_STREAM_NBUF", "3")
            ref = jax_rpa(d["jq"], d["jpool"], 0, jnp.asarray(d["pt"]), jnp.asarray(kvl),
                          jmeta, page_size=PS, scale=scale, kv_block=16, interpret=True)
        out = rpa.ragged_paged_attention(d["tq"], d["tpool"], 0, _t(d["pt"]), _t(kvl), meta,
                                         page_size=PS, scale=scale, stream=True)
    else:
        ref = jax_rpa(d["jq"], d["jpool"], 0, jnp.asarray(d["pt"]), jnp.asarray(kvl),
                      jmeta, page_size=PS, scale=scale, interpret=True)
        out = rpa.ragged_paged_attention(d["tq"], d["tpool"], 0, _t(d["pt"]), _t(kvl), meta,
                                         page_size=PS, scale=scale)
    assert out.shape == (T, HEADS, D) and out.dtype == d["tq"].dtype
    if kind == "extend":
        n = sum(q_lens)
        _close(out, ref, slice(0, n), tol)
        assert not out[n:].any(), "bucket-padding rows must stay zero"
    else:
        _close(out, ref, kvl > 0, tol)
        assert not out[1].any(), "rows with kv_len == 0 must be zeros"
