"""The Llama-computation variants of the port (models/llama_variants.py,
glm.py, phi3.py, granite.py, grok.py) against the JAX package on the CPU,
with the same numpy inputs:

- InternLM2 and its reward model, ExaOne, Baichuan with RoPE and with
  ALiBi, QWen v1, MiniCPM, XverseMoe, DeepSeek-V1, Glm, Glm4, ChatGLM (32
  query heads over 2 KV groups: G = 16), Phi-3, Granite and Grok-1 (6
  query heads a KV head) at tiny widths (2 layers, head_dim 128 on the 5D
  pool, MiniCPM at 64 on the merged one), each a HuggingFace config dict
  read by both packages' ``from_hf_config``: the parameter tree leaf for
  leaf against the JAX ``param_specs`` and ``init_params(seed)``, and the
  float32 logits of an extend step and two decode steps within 1e-4 of
  the JAX model's ``forward``, with each class's own hooks checked against
  the JAX class's (scales, multipliers, rope style, slopes);
- the Engine's greedy tokens equal to the JAX Engine's, colocated (and
  semi-PD on ChatGLM), for one class per distinct forward, and the reward
  model's scores through ``Engine.encode``;
- ``alibi_slopes`` against the JAX schedule; the refusals: ALiBi with
  ``decode_stream``, with speculation, on another pool; XverseMoe at its
  published head_dim 80 (ROADMAP A9).

The plain attention of this slice (ALiBi, G = 6 and 16, the merged pool at
Hkv 36) is in tests/test_torch_alibi.py. Helpers and the engine-pair
fixture come from tests/test_torch_families.py.
"""

import types

import numpy as np
import pytest
import torch

from semi_pd_tpu.config.model_config import ModelConfig as JaxModelConfig
from semi_pd_tpu.models import llama_variants as jax_variants

import chip_smoke
from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.config.server_args import ServerArgs
from semi_pd_tpu_torch.models import llama_variants
from semi_pd_tpu_torch.models.glm import ChatGLMForCausalLM, Glm4ForCausalLM, GlmForCausalLM
from semi_pd_tpu_torch.models.granite import GraniteForCausalLM
from semi_pd_tpu_torch.models.grok import Grok1ForCausalLM
from semi_pd_tpu_torch.models.llama import dtype_scalar
from semi_pd_tpu_torch.models.llama_variants import (
    BaichuanForCausalLM, DeepseekForCausalLM, ExaoneForCausalLM, InternLM2ForCausalLM,
    InternLM2ForRewardModel, MiniCPMForCausalLM, QWenLMHeadModel, XverseMoeForCausalLM,
)
from semi_pd_tpu_torch.models.phi3 import Phi3ForCausalLM
from semi_pd_tpu_torch.runtime.engine import Engine
from semi_pd_tpu_torch.runtime.model_runner import ARCHITECTURES
from test_torch_families import (  # noqa: F401 (engines: a fixture)
    VOCAB, check_engine_matches_jax, check_logits_match_jax,
    check_params_match_jax, engines, hf_config,
)


def _without(d, *keys):
    return {k: v for k, v in d.items() if k not in keys}


# each class at tiny widths; the dicts use each family's own keys where
# from_hf_config has a clause for it
VARIANTS = {
    "internlm2": (InternLM2ForCausalLM, hf_config("InternLM2ForCausalLM")),
    "internlm2_reward": (InternLM2ForRewardModel, hf_config("InternLM2ForRewardModel")),
    "exaone": (ExaoneForCausalLM, {**_without(hf_config("ExaoneForCausalLM"),
                                              "num_hidden_layers", "hidden_act"),
                                   "num_layers": 2, "activation_function": "silu"}),
    "baichuan": (BaichuanForCausalLM, hf_config("BaichuanForCausalLM", num_key_value_heads=4)),
    "baichuan_alibi": (BaichuanForCausalLM, hf_config(
        "BaichuanForCausalLM", num_key_value_heads=4, position_embedding="ALIBI")),
    "qwen": (QWenLMHeadModel, {**_without(hf_config("QWenLMHeadModel", num_key_value_heads=4),
                                          "rope_theta", "max_position_embeddings"),
                               "intermediate_size": 192, "rotary_emb_base": 10000,
                               "seq_length": 256}),
    "minicpm": (MiniCPMForCausalLM, hf_config(
        "MiniCPMForCausalLM", head_dim=64, num_key_value_heads=4, scale_emb=12,
        scale_depth=1.4, dim_model_base=16, tie_word_embeddings=True)),
    "xverse_moe": (XverseMoeForCausalLM, hf_config(
        "XverseMoeForCausalLM", num_experts=4, moe_top_k=2, num_experts_per_tok=2,
        n_shared_experts=1, norm_topk_prob=True)),
    "deepseek_v1": (DeepseekForCausalLM, hf_config(
        "DeepseekForCausalLM", num_key_value_heads=4, n_routed_experts=4,
        num_experts_per_tok=2, moe_intermediate_size=32, n_shared_experts=1,
        first_k_dense_replace=1, moe_layer_freq=1, norm_topk_prob=False)),
    "glm": (GlmForCausalLM, hf_config("GlmForCausalLM", partial_rotary_factor=0.5)),
    "glm4": (Glm4ForCausalLM, hf_config("Glm4ForCausalLM", partial_rotary_factor=0.5)),
    "chatglm": (ChatGLMForCausalLM, dict(
        architectures=["ChatGLMModel"], padded_vocab_size=VOCAB, hidden_size=64,
        ffn_hidden_size=96, num_layers=2, num_attention_heads=32, kv_channels=128,
        multi_query_attention=True, multi_query_group_num=2, layernorm_epsilon=1e-5,
        seq_length=256, rope_ratio=2, add_qkv_bias=True, add_bias_linear=False,
        tie_word_embeddings=False)),
    "phi3": (Phi3ForCausalLM, hf_config("Phi3ForCausalLM", sliding_window=24)),
    "granite": (GraniteForCausalLM, hf_config(
        "GraniteForCausalLM", embedding_multiplier=12.0, attention_multiplier=0.0078125,
        residual_multiplier=0.22, logits_scaling=16.0, tie_word_embeddings=True)),
    "grok": (Grok1ForCausalLM, hf_config(
        "Grok1ForCausalLM", num_attention_heads=6, num_key_value_heads=1,
        num_local_experts=4, num_experts_per_tok=2, embedding_multiplier_scale=7.8,
        output_multiplier_scale=0.577, router_logit_softcapping=3.0)),
}


def _lift(jparams, tm, path, by=1.0):
    """Add ``by`` to a leaf on both sides (norms at 1 + w: the random 0.02
    N(0, 1) weights leave the attention near uniform)."""
    tm.leaf(path).add_(by)
    node = jparams
    keys = path.split(".")
    for k in keys[:-1]:
        node = node[k]
    node[keys[-1]] = node[keys[-1]] + by


@pytest.mark.parametrize("family", list(VARIANTS))
def test_params_and_logits_match_jax(family):
    """Each class draws the JAX parameters leaf for leaf (the reward
    model's ``v_head``, DeepSeek-V1's dense and expert stacks on every
    layer, XverseMoe's ungated shared expert, the sandwich norms of Glm4
    and Grok-1) and gives the JAX model's float32 logits within 1e-4 over
    an extend step and two decode steps, with its hooks set as the JAX
    class sets them."""
    cls, hf = VARIANTS[family]
    jm, jparams, tm = check_params_match_jax(hf, cls)
    paths = dict(tm.param_specs())
    c = tm.config
    assert tm.scale == jm.scale
    assert tm.no_rope == jm.no_rope
    assert tm.rope.is_neox_style == jm.rope.is_neox_style
    assert tm.rope.rotary_dim == jm.rope.rotary_dim
    for attr in ("embed_scale", "residual_mult", "logits_div"):
        want, got = getattr(jm, attr), getattr(tm, attr)
        assert (got is None) == (want is None), attr
        if want is not None:  # float32 here: the JAX scalar rounded to it
            assert got == dtype_scalar(want, torch.float32), attr
    if family == "baichuan_alibi":
        np.testing.assert_array_equal(tm.alibi_slopes.numpy(), np.asarray(jm.alibi_slopes))
        assert tm.no_rope
    else:
        assert tm.alibi_slopes is None and jm.alibi_slopes is None
    if family == "internlm2_reward":
        assert paths["v_head.w"] == (64, 1) and tm.lm_head is None and c.is_embedding
    if family == "deepseek_v1":
        assert paths["layers.dense_gate_up.w"] == (2, 64, 192)
        assert [tm._is_moe_layer(i) for i in (0, 1)] == [False, True]
    if family == "xverse_moe":
        assert "layers.shared.gate.w" not in paths and "layers.shared.down.w" in paths
    if family in ("glm", "glm4", "chatglm"):
        assert not tm.rope.is_neox_style and tm.rope.rotary_dim == 64
    if family == "chatglm":
        assert c.attention_bias and (c.num_attention_heads, c.num_key_value_heads) == (32, 2)
        assert c.rope_theta == 20000.0
    if family == "grok":
        assert c.attn_logit_softcap == jm.config.attn_logit_softcap == 30.0
        assert not c.norm_topk_prob and tm.router_softcap == jm.router_softcap == 3.0
    if family == "qwen":
        assert c.attention_bias and c.intermediate_size == 96
    # the attention's input norms at 1 + w, and each class's sandwich norms
    for path in ("layers.input_norm", "layers.post_attn_sandwich", "layers.post_mlp_sandwich",
                 "layers.post_moe_sandwich"):
        if path in paths:
            _lift(jparams, tm, path)
    if "layers.qkv_proj.b" in paths:
        _lift(jparams, tm, "layers.qkv_proj.b", 0.5)
    check_logits_match_jax(jm, jparams, tm)


def test_reward_scores_match_jax():
    """The reward model's ``forward_embedding``: the ``v_head`` score of each
    request's last token, float32 [B, 1], equal to the JAX model's within
    1e-5 (through the engines' ``encode``)."""
    _, hf = VARIANTS["internlm2_reward"]
    from test_torch_families import engine_pair

    jeng, teng = engine_pair(hf)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, VOCAB, size=n).tolist() for n in (9, 30, 20)]
    want = np.asarray(jeng.encode(input_ids=prompts))
    got = np.asarray(teng.encode(input_ids=prompts))
    assert got.shape == want.shape == (3, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.ptp(got) > 0
    assert teng.flush_cache() and jeng.flush_cache()


# one class per distinct forward; the window of Phi-3 and the rest ride on
# the logits test above
SERVED = ("baichuan_alibi", "minicpm", "chatglm", "glm4", "deepseek_v1", "grok", "granite")


@pytest.mark.parametrize("family", SERVED)
def test_engine_greedy_tokens_match_jax(family, engines):
    """Each forward served by the port's Engine on the JAX Engine's weights
    gives the JAX Engine's greedy tokens, colocated (ChatGLM also semi-PD);
    ALiBi on the 5D pool at head_dim 128, MiniCPM on the merged pool."""
    pair = engines(family, VARIANTS[family][1])
    check_engine_matches_jax(pair, False)
    if family == "chatglm":
        check_engine_matches_jax(pair, True)
    buf = pair[1].runner.kv_cache.buffer
    assert buf.shape[1] == 2 and buf.shape[-1] == (64 if family == "minicpm" else 128)


# ------------------------------------------------------- ALiBi's slopes
@pytest.mark.parametrize("n", [40, 36, 48, 12, 8, 1])
def test_alibi_slopes_match_jax(n):
    """The slope schedule of n heads, a power of two or not (Baichuan2-13B's
    40), bitwise the JAX one's."""
    got = llama_variants.alibi_slopes(n)
    assert got.dtype == np.float32 and got.shape == (n,)
    np.testing.assert_array_equal(got, jax_variants.alibi_slopes(n))


def test_alibi_rule_follows_the_jax_class():
    """ALiBi when the config says position_embedding "ALIBI", or leaves it
    out at hidden 5120 (Baichuan2-13B); RoPE at Baichuan2-7B's 4096 and
    where the config says "ROPE"."""
    P = chip_smoke.PUBLISHED
    for repo, alibi in (("baichuan-inc/Baichuan2-13B-Chat", True),
                        ("baichuan-inc/Baichuan2-7B-Base", False)):
        cfg = ModelConfig.from_hf_config(P[repo])
        cfg.num_hidden_layers = 1
        m = BaichuanForCausalLM(cfg, device="meta")
        assert m.no_rope == alibi and (m.alibi_slopes is not None) == alibi
    rope = ModelConfig.from_hf_config(hf_config("BaichuanForCausalLM", hidden_size=5120,
                                                position_embedding="ROPE"))
    rope.num_hidden_layers = 1
    assert not BaichuanForCausalLM(rope, device="meta").no_rope


# ------------------------------------------------------------- refusals
def _alibi_args(**kw):
    return ServerArgs(random_weights=True, device="cpu", page_size=16, max_total_tokens=1024,
                      **kw)


@pytest.mark.parametrize("what", ["decode_stream", "speculation", "chunked_pool"])
def test_alibi_refusals_name_the_roadmap(what):
    """ALiBi is served on the 5D pool at head_dim 128 without the streaming
    decode or speculation: each other combination raises, naming ROADMAP
    B9.6 (the instantiations it would need)."""
    hf = VARIANTS["baichuan_alibi"][1]
    kw = {}
    if what == "decode_stream":
        kw = dict(decode_stream=True)
    elif what == "speculation":
        kw = dict(speculative_algorithm="NGRAM", speculative_num_draft_tokens=4)
    else:  # head_dim 64 with 8 KV heads: the chunked pool
        hf = dict(hf, head_dim=64, num_attention_heads=8, num_key_value_heads=8)
    cfg = ModelConfig.from_hf_config(hf, dtype="float32")
    with pytest.raises(NotImplementedError, match="ROADMAP B9.6"):
        Engine(_alibi_args(**kw), cfg, device="cpu")


def test_xverse_moe_head_dim_80_is_refused():
    """XverseMoe's published geometry (hidden 2560 over 32 heads: head_dim
    80) has no 5D-pool build: refused naming ROADMAP A9, as the JAX
    dispatcher raises for it on the TPU."""
    hf = hf_config("XverseMoeForCausalLM", hidden_size=2560, num_attention_heads=32,
                   num_key_value_heads=32, num_experts=4, moe_top_k=2)
    hf.pop("head_dim")
    cfg = ModelConfig.from_hf_config(hf, dtype="float32")
    assert cfg.head_dim == 80
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        Engine(_alibi_args(), cfg, device="cpu")


def test_every_variant_string_is_served():
    """The JAX registry's strings of these classes are the port's, each to
    the class of the same name."""
    from semi_pd_tpu.models.registry import _ensure_populated, _REGISTRY

    _ensure_populated()
    strings = [a for a, cls in _REGISTRY.items()
               if cls.__module__.split(".")[-1] in ("llama_variants", "glm", "grok", "phi3",
                                                    "granite")
               and a != "MiniCPM3ForCausalLM"]
    assert len(strings) == 18
    for a in strings:
        assert ARCHITECTURES[a].__name__ == _REGISTRY[a].__name__, a


# the published configs of this slice, by the widths the card runs: (heads,
# KV heads, head_dim, layers, vocab)
WIDTHS = {"THUDM/chatglm3-6b": (32, 2, 128, 28, 65024),
          "THUDM/glm-4-9b-chat": (32, 2, 128, 40, 151552),
          "baichuan-inc/Baichuan2-13B-Chat": (40, 40, 128, 40, 125696),
          "baichuan-inc/Baichuan2-7B-Base": (32, 32, 128, 32, 125696),
          "openbmb/MiniCPM-2B-sft-bf16": (36, 36, 64, 40, 122753),
          "deepseek-ai/deepseek-moe-16b-base": (16, 16, 128, 28, 102400),
          "internlm/internlm2-20b": (48, 8, 128, 48, 92544),
          "internlm/internlm2-7b-reward": (32, 8, 128, 32, 92544),
          "LGAI-EXAONE/EXAONE-3.0-7.8B-Instruct": (32, 8, 128, 32, 102400),
          "Qwen/Qwen-7B": (32, 32, 128, 32, 151936),
          "microsoft/Phi-3-medium-4k-instruct": (40, 10, 128, 40, 32064),
          "ibm-granite/granite-3.0-8b-instruct": (32, 8, 128, 40, 49155),
          "xai-org/grok-1": (48, 8, 128, 64, 131072)}


@pytest.mark.parametrize("repo", list(WIDTHS))
def test_published_widths_as_the_card_runs_them(repo):
    """The published configs of this slice read to the widths the card
    runs, by both packages (the field-for-field check against the JAX
    reading is tests/test_torch_families.py's, over chip_smoke.PUBLISHED)."""
    hf = chip_smoke.PUBLISHED[repo]
    t = ModelConfig.from_hf_config(hf)
    j = JaxModelConfig.from_hf_config(types.SimpleNamespace(**hf))
    for cfg in (t, j):
        assert (cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim,
                cfg.num_hidden_layers, cfg.vocab_size) == WIDTHS[repo]


def test_a_pool_full_of_cached_prefixes_still_admits():
    """When nothing runs and the radix cache holds the pages the next
    waiting request needs (finished prompts' prefixes filling a small
    pool), the scheduler evicts for it instead of leaving it waiting until
    the Engine aborts it (ROADMAP C16: the admission counts free pages
    only; found serving Baichuan2-13B's 57344-token pool). The JAX
    scheduler, whose admission this is, aborts the last two here."""
    from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams

    cfg = ModelConfig.from_hf_config(hf_config("LlamaForCausalLM", num_hidden_layers=1,
                                               max_position_embeddings=1024), dtype="float32")
    args = ServerArgs(random_weights=True, page_size=16, max_total_tokens=1024,
                      chunked_prefill_size=256, decode_bs_buckets=[4], device="cpu")
    eng = Engine(args, cfg, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, VOCAB, size=n).tolist() for n in (300, 300, 300, 200)]
    outs = eng.generate(input_ids=prompts, sampling_params=SamplingParams(
        max_new_tokens=8, temperature=0.0, ignore_eos=True))
    assert [o["meta_info"]["finish_reason"] for o in outs] == ["length"] * 4
    assert all(len(o["output_ids"]) == 8 for o in outs)
    assert eng.flush_cache()
