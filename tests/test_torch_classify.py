"""The sequence classifiers and embedding trunks of the port
(models/classify.py; LlamaModel, MistralModel and LlamaEmbeddingModel on
the Llama class) against the JAX package on the CPU, float32, at tiny
widths (2 layers, hidden 64, vocab 128; tests/test_classify.py's, at
head_dim 128: the 5D pool the port's kernels serve):

- LlamaForSequenceClassification with 3 labels, Gemma2ForSequenceClassification
  at head_dim 128 (Skywork-Reward-Gemma-2-27B's head width and its
  ``query_pre_attn_scalar`` 144: 4 / 2 heads, a window of 8 on alternate
  layers that the prompts pass, softcaps 20 / 10, which the config's keys
  set) on the aligned pool, Qwen2ForRewardModel
  (qkv bias, tied embedding, the Linear -> ReLU -> Linear head): the
  parameter trees leaf for leaf against the JAX ``param_specs`` and
  ``init_params(seed)``, and the scores through ``Engine.encode`` within
  1e-4 of the JAX Engine's;
- the embedding trunks' ``encode`` against the JAX Engine's;
- ``from_hf_config`` (``is_embedding`` by the JAX rule, ``num_labels``)
  and the classifiers' refusal to generate or score.

The norms and the attention's q / k norms are lifted to 1 on both sides
(``lift``), so that the attention moves the scores.
"""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from semi_pd_tpu.config.model_config import ModelConfig as JaxModelConfig

from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.runtime.model_runner import ARCHITECTURES
from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams

from test_torch_families import VOCAB, engine_pair, hf_config, jax_paths

CLASSIFIERS = {
    "llama_cls": hf_config("LlamaForSequenceClassification", num_labels=3),
    "gemma2_cls": hf_config("Gemma2ForSequenceClassification", num_key_value_heads=2,
                            hidden_act="gelu_pytorch_tanh", tie_word_embeddings=True,
                            sliding_window=8, attn_logit_softcapping=20.0,
                            final_logit_softcapping=10.0, query_pre_attn_scalar=144,
                            num_labels=1),
    "qwen2_rm": hf_config("Qwen2ForRewardModel"),
}
TRUNKS = {arch: hf_config(arch) for arch in ("LlamaModel", "MistralModel",
                                             "LlamaEmbeddingModel")}


def lift(jeng, teng):
    """Every norm weight (Gemma's (1 + w): 0) of both engines' models at 1,
    the same numbers on both sides."""
    tree = jax.tree.map(np.asarray, jeng.runner.params)
    gemma = "Gemma" in teng.runner.model_config.architecture
    for k, v in tree["layers"].items():
        if "norm" in k:
            tree["layers"][k] = np.zeros_like(v) if gemma else np.ones_like(v)
    tree["final_norm"] = np.zeros_like(tree["final_norm"]) if gemma else np.ones_like(
        tree["final_norm"])
    jeng.runner.params = jax.tree.map(jnp.asarray, tree)
    teng.runner.model.load_jax_params(tree)


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(name, hf):
        if name not in cache:
            cache[name] = engine_pair(hf)
            lift(*cache[name])
        return cache[name]

    yield get
    cache.clear()


def prompts(seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, size=n).tolist() for n in (9, 20, 30)]


@pytest.mark.parametrize("name", list(CLASSIFIERS))
def test_param_trees_match_jax(name):
    """The tree without an lm_head and with the score leaves, leaf for leaf
    in the JAX order, and the JAX ``init_params(seed)`` numbers."""
    from semi_pd_tpu.models.registry import create_model as jax_create_model

    hf = CLASSIFIERS[name]
    jcfg = JaxModelConfig.from_hf_config(types.SimpleNamespace(**hf), dtype="float32")
    jm = jax_create_model(jcfg)
    jtree = jm.init_params(4)
    tcfg = ModelConfig.from_hf_config(hf, dtype="float32")
    tm = ARCHITECTURES[hf["architectures"][0]](tcfg, device="cpu")
    specs = tm.param_specs()
    paths = [p for p, _ in specs]
    assert paths == jax_paths(jtree)
    assert not any(p.startswith("lm_head") for p in paths)
    assert any(p.startswith("score") for p in paths)
    tm.init_params(4)
    for (path, shape), leaf in zip(specs, jax.tree.leaves(jtree)):
        assert tuple(leaf.shape) == shape, path
        np.testing.assert_array_equal(tm.leaf(path).numpy(), np.asarray(leaf), err_msg=path)


@pytest.mark.parametrize("name", list(CLASSIFIERS))
def test_scores_match_jax(name, pairs):
    """``Engine.encode``: the raw float32 scores [B, num_labels] of each
    request's last final-normed hidden state, within 1e-4 of the JAX
    Engine's; they differ between prompts and do not see the page size."""
    jeng, teng = pairs(name, CLASSIFIERS[name])
    want = np.asarray(jeng.encode(input_ids=prompts()))
    got = np.asarray(teng.encode(input_ids=prompts()))
    labels = CLASSIFIERS[name].get("num_labels", 1)
    assert got.shape == want.shape == (3, labels)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert np.ptp(got) > 0
    one = np.asarray(teng.encode(input_ids=prompts()[1]))
    np.testing.assert_allclose(one, got[1], rtol=1e-5, atol=1e-6)
    if name == "gemma2_cls":  # head_dim 128: the 5D pool of the aligned builds
        buf = teng.runner.kv_cache.buffer
        assert buf.shape[1] == 2 and buf.shape[-1] == 128
        assert teng.runner.model.layer_windows == [8, None]
        assert teng.runner.model.scale == jeng.runner.model.scale == 144 ** -0.5
        assert teng.runner.model_config.attn_logit_softcap == 20.0
    assert teng.flush_cache() and jeng.flush_cache()


@pytest.mark.parametrize("arch", list(TRUNKS))
def test_embedding_trunks_match_jax(arch, pairs):
    """The JAX registry's embedding trunks on Llama: the normalized last
    hidden state of each request, within 1e-5 of the JAX Engine's."""
    jeng, teng = pairs(arch, TRUNKS[arch])
    want = np.asarray(jeng.encode(input_ids=prompts(4)))
    got = np.asarray(teng.encode(input_ids=prompts(4)))
    assert got.shape == want.shape == (3, 64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)
    assert teng.flush_cache() and jeng.flush_cache()


def test_classifiers_refuse_to_generate():
    """A classifier produces no logits: generate and score raise (on an
    engine of its own: a refused step leaves its request's memory held),
    encode serves."""
    from semi_pd_tpu_torch.config.server_args import ServerArgs
    from semi_pd_tpu_torch.runtime.engine import Engine

    from test_torch_families import SERVE

    for name, hf in CLASSIFIERS.items():
        eng = Engine(ServerArgs(random_weights=True, device="cpu", **SERVE),
                     ModelConfig.from_hf_config(hf, dtype="float32"), device="cpu")
        assert np.isfinite(np.asarray(eng.encode(input_ids=[1, 2, 3]))).all()
        with pytest.raises(NotImplementedError, match="Engine.encode"):
            eng.generate(input_ids=[1, 2, 3],
                         sampling_params=SamplingParams(max_new_tokens=2, temperature=0.0))
        eng = Engine(ServerArgs(random_weights=True, device="cpu", **SERVE),
                     ModelConfig.from_hf_config(hf, dtype="float32"), device="cpu")
        with pytest.raises(NotImplementedError, match="Engine.encode"):
            eng.score(input_ids=[1, 2, 3])


def test_from_hf_config_matches_jax():
    """The twelve strings of this slice are read, ``is_embedding`` by the
    JAX rule (a string ending in Model or Classification, or naming a
    Reward), the classifiers' num_labels from the config or its
    id2label."""
    from semi_pd_tpu_torch.models.classify import num_labels

    for hf in list(CLASSIFIERS.values()) + list(TRUNKS.values()):
        j = JaxModelConfig.from_hf_config(types.SimpleNamespace(**hf), dtype="float32")
        t = ModelConfig.from_hf_config(hf, dtype="float32")
        for f in ("architecture", "hidden_size", "num_hidden_layers", "head_dim",
                  "num_key_value_heads", "is_embedding", "tie_word_embeddings"):
            assert getattr(t, f) == getattr(j, f), (hf["architectures"], f)
        assert t.is_embedding and not t.is_multimodal
    assert num_labels({"id2label": {"0": "a", "1": "b"}}) == 2
    assert num_labels({"num_labels": 5}) == 5 and num_labels({}) == 1
    for arch in ("LlavaForConditionalGeneration", "LlavaLlamaForCausalLM", "YiVLForCausalLM",
                 "LlavaVidForCausalLM", "Qwen2VLForConditionalGeneration",
                 "Qwen2_5_VLForConditionalGeneration", *CLASSIFIERS_ARCHS, *TRUNKS):
        assert arch in ARCHITECTURES


CLASSIFIERS_ARCHS = [hf["architectures"][0] for hf in CLASSIFIERS.values()]
