"""The GQA MoE families of the port (models/qwen2_moe.py) against the JAX
package on the CPU, with the same numpy inputs:

- Mixtral (top-k weights always renormalized), Qwen2-MoE (the qkv bias,
  a shared expert of ``shared_expert_intermediate_size`` behind its
  sigmoid gate, multi-head as Qwen1.5-MoE-A2.7B), Qwen3-MoE (per-head q/k
  norms, ``norm_topk_prob``, 8 query heads on one KV head as
  Qwen3-30B-A3B's G = 8) and OLMoE (q/k norms over the full projections,
  multi-head) at tiny widths (2 layers, hidden 64, 4-8 experts), each
  config a HuggingFace dict read by both packages' ``from_hf_config``: the
  parameter tree leaf for leaf against the JAX ``param_specs`` and
  ``init_params(seed)``, float32 logits of an extend step and two decode
  steps within 1e-4 of the JAX model's ``forward``, and the Engine's
  greedy tokens equal to the JAX Engine's, colocated and semi-PD;
- the runner's random weights (``device_init_params``) over the expert
  stacks, a layer at a time;
- ``route_topk`` with ``norm_topk_prob`` off and on against the JAX one.

Helpers and the engine-pair fixture come from tests/test_torch_families.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semi_pd_tpu.ops import moe as jax_moe

from semi_pd_tpu_torch.model_loader import loader
from semi_pd_tpu_torch.models.qwen2_moe import (
    MixtralForCausalLM, OlmoeForCausalLM, Qwen2MoeForCausalLM, Qwen3MoeForCausalLM,
)
from semi_pd_tpu_torch.ops import moe
from test_torch_families import (  # noqa: F401 (engines: a fixture)
    both_configs, check_engine_matches_jax, check_logits_match_jax, check_params_match_jax,
    engines, hf_config,
)

MOE = {
    "mixtral": (MixtralForCausalLM, hf_config(
        "MixtralForCausalLM", num_local_experts=4, num_experts_per_tok=2, sliding_window=None)),
    "qwen2_moe": (Qwen2MoeForCausalLM, hf_config(
        "Qwen2MoeForCausalLM", num_key_value_heads=4, num_experts=8, num_experts_per_tok=2,
        moe_intermediate_size=32, shared_expert_intermediate_size=64, norm_topk_prob=False,
        rope_theta=1000000.0)),
    "qwen3_moe": (Qwen3MoeForCausalLM, hf_config(
        "Qwen3MoeForCausalLM", num_attention_heads=8, num_key_value_heads=1, num_experts=8,
        num_experts_per_tok=4, moe_intermediate_size=32, norm_topk_prob=True,
        attention_bias=False, rope_theta=1000000.0)),
    "olmoe": (OlmoeForCausalLM, hf_config(
        "OlmoeForCausalLM", num_key_value_heads=4, num_experts=8, num_experts_per_tok=4,
        intermediate_size=32, norm_topk_prob=False, attention_bias=False)),
}


@pytest.mark.parametrize("family", list(MOE))
def test_params_and_logits_match_jax(family):
    """Each MoE class draws the JAX parameters leaf for leaf (the router,
    the expert stacks without a ``.w`` level, Qwen2-MoE's shared expert of
    64 = 2 x 32 with its gate and its qkv bias, Qwen3-MoE's per-head and
    OLMoE's full-width q/k norms) and gives the JAX model's float32 logits
    within 1e-4 over an extend step and two decode steps; the q/k norms
    and the bias are lifted so that they show."""
    cls, hf = MOE[family]
    jm, jparams, tm = check_params_match_jax(hf, cls)
    shapes = dict(tm.param_specs())
    c = tm.config
    E = c.num_experts
    assert shapes["layers.router.w"] == (2, 64, E)
    assert shapes["layers.experts.gate_up"] == (2, E, 64, 2 * c.moe_intermediate_size)
    assert ("layers.shared.gate.w" in shapes) == (family == "qwen2_moe")
    assert ("layers.qkv_proj.b" in shapes) == (family == "qwen2_moe")
    if family == "qwen2_moe":
        assert c.num_shared_experts == jm.config.num_shared_experts == 2
        assert shapes["layers.shared.gate_up.w"] == (2, 64, 128)
    if family == "qwen3_moe":
        assert shapes["layers.q_norm"] == shapes["layers.k_norm"] == (2, 128)
    if family == "olmoe":
        assert shapes["layers.q_norm"] == (2, 4 * 128) and shapes["layers.k_norm"] == (2, 4 * 128)
    for path in ("layers.qkv_proj.b", "layers.q_norm", "layers.k_norm"):
        if path in shapes:
            tm.leaf(path).add_(1.0)
            node = jparams["layers"]
            for k in path.split(".")[1:-1]:
                node = node[k]
            key = path.split(".")[-1]
            node[key] = node[key] + 1.0
    check_logits_match_jax(jm, jparams, tm)


@pytest.mark.parametrize("semi_pd", [False, True], ids=["colocated", "semi_pd"])
@pytest.mark.parametrize("family", list(MOE))
def test_engine_greedy_tokens_match_jax(family, semi_pd, engines):
    """Each MoE string served by the port's Engine on the JAX Engine's
    weights gives the JAX Engine's greedy tokens, colocated and semi-PD."""
    cls, hf = MOE[family]
    pair = engines(family, hf)
    assert type(pair[1].runner.model) is cls
    check_engine_matches_jax(pair, semi_pd)


def test_device_init_draws_the_expert_stacks_a_layer_at_a_time(monkeypatch):
    """The runner's random weights (device_init_params) fill every leaf of
    Qwen2-MoE's tree, the expert stacks and the shared expert included, at
    0.02 N(0, 1) from a generator of their own; a stacked leaf is drawn one
    layer at a time (no draw holds two layers of the expert stack); the
    same seed draws the same numbers."""
    _, tcfg = both_configs(MOE["qwen2_moe"][1])
    a, b = (Qwen2MoeForCausalLM(tcfg, device="cpu") for _ in range(2))
    shapes = []
    randn = torch.randn
    monkeypatch.setattr(loader.torch, "randn",
                        lambda shape, **kw: shapes.append(tuple(shape)) or randn(shape, **kw))
    loader.device_init_params(a, seed=3)
    loader.device_init_params(b, seed=3)
    E, F = tcfg.num_experts, tcfg.moe_intermediate_size
    assert (E, 64, 2 * F) in shapes and (2, E, 64, 2 * F) not in shapes
    seen = []
    for path, shape in a.param_specs():
        x = a.leaf(path)
        assert x.shape == shape and torch.equal(x, b.leaf(path)), path
        assert 0.01 < float(x.std()) < 0.03, path
        seen.append(x.flatten()[:8])
    assert len({tuple(v.tolist()) for v in seen}) == len(seen)
    assert not torch.equal(a.experts_down[0], a.experts_down[1])


@pytest.mark.parametrize("norm", [False, True], ids=["raw", "norm_topk_prob"])
def test_route_topk_matches_jax(norm):
    """route_topk's softmax top-k over 60 experts (Qwen1.5-MoE's) picks the
    JAX experts and weights, with and without renormalizing the top-k."""
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(37, 60)).astype(np.float32)
    w, idx = moe.route_topk(torch.from_numpy(logits), 4, norm_topk_prob=norm)
    jw, jidx = jax_moe.route_topk(jnp.asarray(logits), 4, norm_topk_prob=norm)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)
    sums = w.sum(-1).numpy()
    if norm:
        np.testing.assert_allclose(sums, 1.0, rtol=1e-6)
    else:
        assert (sums < 0.99).all()
