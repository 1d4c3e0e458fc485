"""The LayerNorm families of the port (models/layernorm_families.py,
gpt2.py, olmo_falcon_dbrx.py) against the JAX package on the CPU, with the
same numpy inputs:

- StableLM, Starcoder2, Phi, Cohere, OLMo-2, Phi-3-small, GPT-2,
  GPT-BigCode, OLMo-1, Falcon and DBRX at tiny widths (2 layers, head_dim
  64 or 128), each a config.json-shaped dict that the port's
  ``from_hf_config`` reads and that the JAX package reads through the
  transformers class built from it (Phi-3-small has none: a namespace of
  the same keys): the parameter tree leaf for leaf against the JAX
  ``param_specs`` and ``init_params(seed)``, the hooks each class sets
  (biases, norms, parallel block, positions, rope style, scales, clip,
  logit bias), and the float32 logits of an extend step and two decode
  steps within 1e-4 of the JAX model's ``forward``;
- the Engine's greedy tokens equal to the JAX Engine's in float32 for the
  four served families (GPT-BigCode, Falcon, StableLM on the chunked pool,
  GPT-2), colocated, and semi-PD on Falcon;
- ``from_hf_config`` on each published config.json of ``chip_smoke.py``
  (``chip_smoke.PUBLISHED_LN``) and on a dict of the architecture string
  alone (every key from the class's defaults) equal to the JAX one on the
  transformers class, field for field, for the 13 strings;
- the refusals: head_dim 80 (Phi-2, StableLM-3B) and 160 (StableLM-2-12B),
  a GPT-2 context past ``n_positions``, Falcon's new decoder architecture
  and ALiBi.

The head groups of the tensor-core decodes at G > 16 (StarCoder's 48,
Falcon-7B's 71) are in tests/test_torch_head_groups.py.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import transformers

from semi_pd_tpu.config.model_config import ModelConfig as JaxModelConfig
from semi_pd_tpu.config.server_args import ServerArgs as JaxServerArgs
from semi_pd_tpu.models.registry import create_model as jax_create_model
from semi_pd_tpu.runtime.engine import Engine as JaxEngine

import chip_smoke
from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.config.server_args import ServerArgs
from semi_pd_tpu_torch.models.gpt2 import GPT2LMHeadModel, GPTBigCodeForCausalLM
from semi_pd_tpu_torch.models.layernorm_families import (
    CohereForCausalLM, Olmo2ForCausalLM, Phi3SmallForCausalLM, PhiForCausalLM,
    StableLmForCausalLM, Starcoder2ForCausalLM,
)
from semi_pd_tpu_torch.models.llama import dtype_scalar
from semi_pd_tpu_torch.models.olmo_falcon_dbrx import (
    DbrxForCausalLM, FalconForCausalLM, OlmoForCausalLM,
)
from semi_pd_tpu_torch.runtime.engine import Engine
from semi_pd_tpu_torch.runtime.model_runner import ARCHITECTURES
from test_torch_families import (
    SERVE, VOCAB, check_engine_matches_jax, check_logits_match_jax, hf_config, jax_paths,
    shared_fields,
)

# the transformers class the JAX package reads each string through
HF_CLASSES = {
    "StableLmForCausalLM": "StableLmConfig", "StableLmEpochForCausalLM": "StableLmConfig",
    "Starcoder2ForCausalLM": "Starcoder2Config", "PhiForCausalLM": "PhiConfig",
    "CohereForCausalLM": "CohereConfig", "Olmo2ForCausalLM": "Olmo2Config",
    "GPT2LMHeadModel": "GPT2Config", "GPTBigCodeForCausalLM": "GPTBigCodeConfig",
    "OlmoForCausalLM": "OlmoConfig", "FalconForCausalLM": "FalconConfig",
    "RWForCausalLM": "FalconConfig", "DbrxForCausalLM": "DbrxConfig",
}


def hf_object(hf: dict):
    """The config as the JAX package gets it: the transformers class built
    from the dict, or for Phi-3-small (remote code) a namespace of its keys."""
    name = HF_CLASSES.get(hf["architectures"][0])
    return getattr(transformers, name)(**hf) if name else types.SimpleNamespace(**hf)


def configs(hf: dict, **kw):
    """(JAX ModelConfig, port ModelConfig) of ``hf`` in float32."""
    jcfg = JaxModelConfig.from_hf_config(hf_object(hf), dtype="float32", **kw)
    tcfg = ModelConfig.from_hf_config(hf, dtype="float32", **kw)
    return jcfg, tcfg


def _gpt(arch, **kw):
    return {**dict(architectures=[arch], vocab_size=VOCAB, n_layer=2, n_positions=256,
                   layer_norm_epsilon=1e-5), **kw}


# each class at tiny widths, in its family's own keys. StableLM at 8 heads
# of 64 over 8 KV heads (the chunked pool, as StableLM-2-1.6B), Starcoder2
# at G = 3 with a window the prompts pass, Falcon and GPT-BigCode
# multi-query (one KV head), GPT-2 and Falcon at head_dim 64 (the merged
# pool), the clips and Phi-3-small's gegelu limit small enough to cut the
# random weights' values
FAMILIES = {
    "stablelm": (StableLmForCausalLM, hf_config(
        "StableLmForCausalLM", head_dim=64, num_attention_heads=8, num_key_value_heads=8,
        use_qkv_bias=True, partial_rotary_factor=0.25, layer_norm_eps=1e-5)),
    "starcoder2": (Starcoder2ForCausalLM, hf_config(
        "Starcoder2ForCausalLM", num_attention_heads=6, num_key_value_heads=2, use_bias=True,
        hidden_act="gelu_pytorch_tanh", norm_epsilon=1e-5, sliding_window=24,
        tie_word_embeddings=True)),
    "phi": (PhiForCausalLM, hf_config(
        "PhiForCausalLM", head_dim=64, num_key_value_heads=4, partial_rotary_factor=0.5,
        hidden_act="gelu_new", layer_norm_eps=1e-5)),
    "cohere": (CohereForCausalLM, hf_config(
        "CohereForCausalLM", logit_scale=0.25, layer_norm_eps=1e-5, tie_word_embeddings=True)),
    "olmo2": (Olmo2ForCausalLM, hf_config("Olmo2ForCausalLM", num_key_value_heads=4)),
    "phi3small": (Phi3SmallForCausalLM, hf_config(
        "Phi3SmallForCausalLM", hidden_act="gegelu", layer_norm_epsilon=1e-5,
        mup_use_scaling=True, mup_attn_multiplier=1.5, mup_embedding_multiplier=10.0,
        mup_width_multiplier=8.0, gegelu_limit=0.05, dummy_token_indices=[3, 100],
        rope_embedding_base=1000000, rope_position_scale=2.0)),
    "gpt2": (GPT2LMHeadModel, _gpt("GPT2LMHeadModel", n_embd=128, n_head=2,
                                   activation_function="gelu_new")),
    "gpt_bigcode": (GPTBigCodeForCausalLM, _gpt(
        "GPTBigCodeForCausalLM", n_embd=256, n_head=2, multi_query=True,
        activation_function="gelu")),
    "olmo": (OlmoForCausalLM, hf_config("OlmoForCausalLM", clip_qkv=0.1)),
    "falcon": (FalconForCausalLM, dict(
        architectures=["FalconForCausalLM"], vocab_size=VOCAB, hidden_size=256,
        num_attention_heads=4, num_hidden_layers=2, multi_query=True, parallel_attn=True,
        bias=False, new_decoder_architecture=False, alibi=False, layer_norm_epsilon=1e-5,
        max_position_embeddings=256)),
    "dbrx": (DbrxForCausalLM, dict(
        architectures=["DbrxForCausalLM"], vocab_size=VOCAB, d_model=256, n_heads=2,
        n_layers=2, max_seq_len=256,
        attn_config=dict(kv_n_heads=1, clip_qkv=0.1, rope_theta=500000),
        ffn_config=dict(ffn_hidden_size=32, moe_num_experts=4, moe_top_k=2))),
}
# the two other strings, each on its family's class
ALSO = {"StableLmEpochForCausalLM": "stablelm", "RWForCausalLM": "falcon"}


def check_params(hf, cls, seed=7):
    """The port's model has the JAX model's leaves in the JAX tree's order
    and draws the JAX ``init_params(seed)``; returns (JAX model, params,
    port model)."""
    jcfg, tcfg = configs(hf)
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


def check_hooks(jm, tm):
    """The hooks of the port's class as the JAX class sets them."""
    for f in ("attention_bias", "o_proj_bias", "tie_word_embeddings", "partial_rotary_factor",
              "intermediate_size", "rms_norm_eps", "num_key_value_heads", "norm_topk_prob"):
        assert getattr(tm.config, f) == getattr(jm.config, f), f
    assert tm.NORM_BIAS == jm.norm_bias
    assert tm.PARALLEL_BLOCK == jm.parallel_block
    assert tm.POS_EMBED == jm.pos_embed and tm.LM_HEAD_BIAS == jm.lm_head_bias
    assert tm.no_rope == jm.no_rope and tm.qkv_clip == jm.qkv_clip
    assert tm.use_qk_norm == jm.use_qk_norm and tm.QK_NORM_FULL == jm.qk_norm_full
    assert tm.norm_fn.__name__ == {"rms_norm": "rms_norm", "layer_norm": "layer_norm",
                                   "_plain_ln": "plain_layer_norm"}[jm.norm_fn.__name__]
    assert tm.rope.is_neox_style == jm.rope.is_neox_style
    assert tm.rope.rotary_dim == jm.rope.rotary_dim
    assert tm.scale == jm.scale
    for attr in ("embed_scale", "logits_div"):
        want, got = getattr(jm, attr), getattr(tm, attr)
        assert (got is None) == (want is None), attr
        if want is not None:  # float32 here: the JAX scalar rounded to it
            assert got == dtype_scalar(want, torch.float32), attr
    if jm.logit_bias is None:
        assert tm.logit_bias is None
    else:
        np.testing.assert_array_equal(tm.logit_bias.numpy(), jm.logit_bias)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_params_hooks_and_logits_match_jax(family):
    """Each class draws the JAX parameters leaf for leaf ({"w", "b"} norms,
    the non-gated MLP, biases, learned positions, OLMo-1's placeholder
    norms, DBRX's experts), sets the JAX class's hooks, and gives the JAX
    model's float32 logits within 1e-4 over an extend step and two decode
    steps, with the norms lifted to 1 + w (a zero-mean LayerNorm weight
    would leave the attention near uniform) and qkv clipped where set."""
    cls, hf = FAMILIES[family]
    jm, jparams, tm = check_params(hf, cls)
    check_hooks(jm, tm)
    for path, _ in tm.param_specs():
        if "norm" in path and not path.endswith(".b"):
            tm.leaf(path).add_(1.0)
            node = jparams
            keys = path.split(".")
            for k in keys[:-1]:
                node = node[k]
            node[keys[-1]] = node[keys[-1]] + 1.0
    big = check_logits_match_jax(jm, jparams, tm)
    assert big > 0.0


@pytest.mark.parametrize("arch", list(ALSO))
def test_other_strings_take_their_family(arch):
    """StableLmEpochForCausalLM and RWForCausalLM build their family's
    class with the JAX tree: RW's config is read by the JAX rule, which
    gives it the multi-query clause of neither string's name (so every
    query head keeps its KV head, as in the JAX package)."""
    cls, hf = FAMILIES[ALSO[arch]]
    jm, _, tm = check_params({**hf, "architectures": [arch]}, cls)
    check_hooks(jm, tm)
    if arch == "RWForCausalLM":
        assert tm.num_kv_heads == tm.num_heads == 4


def test_family_hooks_read_as_published():
    """The hooks the published models run with: StarCoder and Falcon-7B
    multi-query (G = 48, 71), Falcon's parallel block and exact GELU at 4 x
    hidden, GPT-2's 1024 learned positions, StableLM's partial rotary and
    qkv bias, Cohere's interleaved rope and 1 / logit_scale, Phi-3-small's
    muP scalings, DBRX's clip and renormalized top-4."""
    P = chip_smoke.PUBLISHED_LN
    meta = {}
    for repo, hf in P.items():
        cfg = ModelConfig.from_hf_config(hf, context_length=1024)
        meta[repo] = ARCHITECTURES[cfg.architecture](
            dataclasses.replace(cfg, num_hidden_layers=1), device="meta")
    sc, fa = meta["bigcode/starcoder"], meta["tiiuae/falcon-7b"]
    assert (sc.num_heads, sc.num_kv_heads, sc.head_dim) == (48, 1, 128)
    assert (fa.num_heads, fa.num_kv_heads, fa.head_dim) == (71, 1, 64)
    assert fa.PARALLEL_BLOCK and not fa.MLP_BIAS and fa.config.intermediate_size == 4 * 4544
    assert fa.mlp_act.__name__ == "gelu_exact" and sc.mlp_act.__name__ == "gelu_exact"
    gpt2 = meta["openai-community/gpt2-large"]
    assert dict(gpt2.param_specs())["pos_embed.w"] == (1024, 1280) and gpt2.no_rope
    assert gpt2.mlp_act.__name__ == "gelu_tanh" and gpt2.lm_head is None
    st = meta["stabilityai/stablelm-2-1_6b"]
    assert st.rope.rotary_dim == 16 and st.config.attention_bias
    co = meta["CohereForAI/aya-23-8B"]
    assert not co.ROPE_NEOX and co.logits_div == 16.0 and co.lm_head is None
    p3 = meta["microsoft/Phi-3-small-8k-instruct"]
    assert p3.scale == 1.0 / 128 and p3.logits_div == 8.0 and p3.logit_bias is None
    assert p3.config.intermediate_size == 4 * 4096  # ff_intermediate_size is not read
    db = meta["databricks/dbrx-base"]
    assert db.qkv_clip == 8 and db.config.norm_topk_prob
    assert (db.config.num_experts, db.config.num_experts_per_tok) == (16, 4)


# ------------------------------------------------------------- engines
def engine_pair(hf):
    """A JAX Engine and the port's Engine on its parameters, float32, on
    their CPU paths."""
    jcfg, tcfg = configs(hf)
    jeng = JaxEngine(server_args=JaxServerArgs(model_path="", random_weights=True,
                                               dtype="float32", **SERVE),
                     model_config=jcfg)
    teng = Engine(ServerArgs(random_weights=True, device="cpu", **SERVE), tcfg, device="cpu")
    teng.runner.model.load_jax_params(jax.tree.map(np.asarray, jeng.runner.params))
    return jeng, teng


SERVED = {"gpt_bigcode": ("aligned", 128), "falcon": ("aligned", 64),
          "stablelm": ("chunked", None), "gpt2": ("aligned", 64)}


@pytest.mark.parametrize("family", list(SERVED))
def test_engine_greedy_tokens_match_jax(family):
    """The four families served at full width on the card, each by the
    port's Engine on the JAX Engine's weights: the JAX Engine's greedy
    tokens in float32, colocated (and semi-PD on Falcon), on the pool the
    card serves them from (GPT-BigCode's one KV head at 128, Falcon's at 64
    on the merged pool, StableLM's chunked pool, GPT-2's merged pool)."""
    pair = engine_pair(FAMILIES[family][1])
    for semi_pd in (False, True) if family == "falcon" else (False,):
        check_engine_matches_jax(pair, semi_pd)
    layout, D = SERVED[family]
    runner = pair[1].runner
    assert runner.kv_spec.layout == layout
    if D:
        assert runner.kv_cache.buffer.shape[-1] == D


# ------------------------------------------------------- from_hf_config
@pytest.mark.parametrize("repo", list(chip_smoke.PUBLISHED_LN))
def test_from_hf_config_matches_jax_on_published_configs(repo):
    """The port's from_hf_config of each published config.json dict equals
    the JAX one on the transformers class built from it (Phi-3-small: on a
    namespace), field for field, and the classes' side effects on the
    config agree once both models are built (one layer)."""
    hf = chip_smoke.PUBLISHED_LN[repo]
    jcfg, tcfg = configs(hf, context_length=1024)
    fields = shared_fields()
    assert {f: getattr(tcfg, f) for f in fields} == {f: getattr(jcfg, f) for f in fields}
    jm = jax_create_model(dataclasses.replace(jcfg, num_hidden_layers=1))
    tm = ARCHITECTURES[tcfg.architecture](dataclasses.replace(tcfg, num_hidden_layers=1),
                                          device="meta")
    assert {f: getattr(tm.config, f) for f in fields} == {
        f: getattr(jm.config, f) for f in fields}
    assert [p for p, _ in tm.param_specs()] == jax_paths(jm.param_specs())


@pytest.mark.parametrize("arch", sorted(HF_CLASSES))
def test_from_hf_config_takes_the_hf_class_defaults(arch):
    """A dict of the architecture string alone reads, key by key, what the
    JAX package reads from the transformers class's defaults (the port's
    HF_DEFAULTS), and the aliases of GPT-2, GPT-BigCode and DBRX resolve as
    the class's attribute_map does."""
    jcfg, tcfg = configs({"architectures": [arch]})
    fields = shared_fields()
    assert {f: getattr(tcfg, f) for f in fields} == {f: getattr(jcfg, f) for f in fields}
    if arch in ("GPT2LMHeadModel", "GPTBigCodeForCausalLM", "DbrxForCausalLM"):
        keys = {"GPT2LMHeadModel": ("n_embd", "n_head", "n_layer", "n_positions"),
                "GPTBigCodeForCausalLM": ("n_embd", "n_head", "n_layer", "n_positions"),
                "DbrxForCausalLM": ("d_model", "n_heads", "n_layers", "max_seq_len")}[arch]
        hf = {"architectures": [arch], **dict(zip(keys, (512, 4, 3, 640)))}
        if arch == "DbrxForCausalLM":
            hf.update(attn_config=dict(kv_n_heads=2), ffn_config=dict(moe_num_experts=4))
        jcfg, tcfg = configs(hf)
        assert {f: getattr(tcfg, f) for f in fields} == {f: getattr(jcfg, f) for f in fields}
        assert (tcfg.hidden_size, tcfg.num_attention_heads, tcfg.num_hidden_layers,
                tcfg.max_position_embeddings) == (512, 4, 3, 640)


# ------------------------------------------------------------ refusals
@pytest.mark.parametrize("hidden,heads", [(2560, 32), (5120, 32)], ids=["hd80", "hd160"])
def test_head_dims_without_a_build_are_refused(hidden, heads):
    """Phi-2's and StableLM-3B's head_dim 80 and StableLM-2-12B's 160 have
    no kernel build: the runner refuses them, naming ROADMAP A9, before it
    makes any weight (the JAX dispatcher refuses them on the TPU)."""
    arch = "PhiForCausalLM" if hidden == 2560 else "StableLmForCausalLM"
    cfg = ModelConfig.from_hf_config(hf_config(arch, hidden_size=hidden, head_dim=None,
                                               num_attention_heads=heads,
                                               num_key_value_heads=heads), dtype="float32")
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        Engine(ServerArgs(random_weights=True, device="cpu", **SERVE), cfg, device="cpu")


def test_gpt2_context_past_its_positions_is_refused():
    """GPT-2's learned positions end at n_positions: a longer context is
    refused before any weight is made; at n_positions it serves."""
    hf = FAMILIES["gpt2"][1]
    cfg = ModelConfig.from_hf_config(hf, dtype="float32")
    assert cfg.context_length == cfg.max_position_embeddings == 256
    with pytest.raises(ValueError, match="learned positions"):
        Engine(ServerArgs(random_weights=True, device="cpu", context_length=257, **SERVE),
               cfg, device="cpu")
    with pytest.raises(ValueError, match="learned positions"):
        Engine(ServerArgs(random_weights=True, device="cpu", **SERVE),
               ModelConfig.from_hf_config(hf, context_length=1024), device="cpu")
    eng = Engine(ServerArgs(random_weights=True, device="cpu", **SERVE),
                 ModelConfig.from_hf_config(hf, dtype="float32"), device="cpu")
    assert eng.runner.max_context_len <= 256


@pytest.mark.parametrize("key", ["new_decoder_architecture", "alibi"])
def test_falcon_variants_are_refused(key):
    """Falcon-40B / 180B's new decoder architecture and Falcon with ALiBi
    are refused, as the JAX class refuses them."""
    hf = {**FAMILIES["falcon"][1], key: True}
    jcfg, tcfg = configs(hf)
    with pytest.raises(NotImplementedError):
        jax_create_model(jcfg)
    with pytest.raises(NotImplementedError, match="ROADMAP A14"):
        ARCHITECTURES[tcfg.architecture](tcfg, device="meta")
