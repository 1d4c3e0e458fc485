"""The GQA sparse-MoE families (port of semi_pd_tpu/models/qwen2_moe.py):
Mixtral, Qwen2-MoE, Qwen3-MoE and OLMoE, each the Llama attention
(models/llama.py) with its MLP replaced by routed experts.

- ``MixtralForCausalLM``: softmax top-k routing, the top-k weights always
  renormalized (its HF config has no ``norm_topk_prob``);
- ``Qwen2MoeForCausalLM``: the qkv bias, ``norm_topk_prob`` from the
  config and, where ``num_shared_experts`` is set, a dense shared expert
  of ``num_shared_experts * moe_intermediate_size`` behind a sigmoid gate
  (``ModelConfig.from_hf_config`` sets it from
  ``shared_expert_intermediate_size``, as the JAX class's ``__init__``
  does from its HF config);
- ``Qwen3MoeForCausalLM``: Qwen2-MoE's routing without the bias or a
  shared expert, with Qwen3's per-head q/k norms;
- ``OlmoeForCausalLM``: ``norm_topk_prob`` from the config and the q/k
  norms over the full projection width, before the head split.

The leaves are the JAX tree's: ``layers.router.w`` [L, H, E],
``layers.experts.gate_up`` [L, E, H, 2F] and ``layers.experts.down`` [L, E,
F, H] (no ``.w`` level), ``layers.shared.{gate_up,down,gate}.w``. The
router's logits are taken in float32, ``ops/moe.py::route_topk`` picks the
experts and ``moe_ffn`` runs them as two grouped products with the experts'
row counts made on the device, so a decode step has no host sync and is
replayed from a CUDA graph like a dense one.
"""

from __future__ import annotations

import torch

from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.layers.linear import apply_linear
from semi_pd_tpu_torch.models.llama import LlamaForCausalLM
from semi_pd_tpu_torch.ops.elementwise import silu_and_mul
from semi_pd_tpu_torch.ops.moe import moe_ffn, route_topk


class MixtralForCausalLM(LlamaForCausalLM):
    # HF Mixtral always renormalizes the top-k weights; the others read
    # norm_topk_prob from the config
    NORM_TOPK_FROM_CONFIG = False

    def _mlp_specs(self):
        c = self.config
        L, H = c.num_hidden_layers, c.hidden_size
        E, F = c.num_experts, c.moe_intermediate_size
        specs = [("layers.experts.down", (L, E, F, H)),
                 ("layers.experts.gate_up", (L, E, H, 2 * F)),
                 ("layers.router.w", (L, H, E))]
        if c.num_shared_experts:
            FS = c.num_shared_experts * F
            specs += [("layers.shared.down.w", (L, FS, H)),
                      ("layers.shared.gate.w", (L, H, 1)),
                      ("layers.shared.gate_up.w", (L, H, 2 * FS))]
        return specs

    def _mlp(self, layer: int, x: torch.Tensor) -> torch.Tensor:
        c = self.config
        weights, idx = route_topk(
            apply_linear(x, self.router[layer]).float(), c.num_experts_per_tok,
            norm_topk_prob=c.norm_topk_prob if self.NORM_TOPK_FROM_CONFIG else True)
        out = moe_ffn(x, self.experts_gate_up[layer], self.experts_down[layer], weights, idx)
        if c.num_shared_experts:
            sh = apply_linear(silu_and_mul(apply_linear(x, self.shared_gate_up[layer])),
                              self.shared_down[layer])
            # the JAX order of casts: the gate's logit in float32, its
            # sigmoid cast to the shared expert's dtype
            gate = torch.sigmoid(apply_linear(x, self.shared_gate[layer]).float()).to(sh.dtype)
            out = out + gate * sh
        return out


class Qwen2MoeForCausalLM(MixtralForCausalLM):
    NORM_TOPK_FROM_CONFIG = True

    def __init__(self, config: ModelConfig, device):
        config.attention_bias = True
        super().__init__(config, device)


class Qwen3MoeForCausalLM(MixtralForCausalLM):
    """Qwen2-MoE's routing (norm_topk_prob from the config) without its
    qkv bias, and no shared expert unless the config sets one (the JAX
    class skips Qwen2-MoE's ``__init__``); the per-head q/k norms come with
    the architecture string (models/llama.py QK_NORM_ARCHS)."""

    NORM_TOPK_FROM_CONFIG = True

    def __init__(self, config: ModelConfig, device):
        config.attention_bias = False
        super().__init__(config, device)


class OlmoeForCausalLM(MixtralForCausalLM):
    NORM_TOPK_FROM_CONFIG = True
    QK_NORM_FULL = True
