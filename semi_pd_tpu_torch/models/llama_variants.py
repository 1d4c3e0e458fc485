"""The Llama-computation variants (port of semi_pd_tpu/models/
llama_variants.py): InternLM2 and its reward model, ExaOne, Baichuan, QWen
v1, MiniCPM, XverseMoe and DeepSeek-V1.

In the JAX package each is a Llama or Mixtral subclass whose deltas are
its checkpoint's layout (fused ``wqkv`` / ``W_pack`` / ``c_attn``, gate /
up order: ``hf_weight_plan``, ROADMAP A13) and a few hooks of
models/llama.py, which are what this module sets:

- ``InternLM2ForCausalLM``, ``ExaoneForCausalLM``: Llama's computation
  (ExaOne's depth and activation come from ``from_hf_config``);
- ``InternLM2ForRewardModel``: tied (no lm_head), with a ``v_head`` [H, 1]
  leaf that scores each request's last final-normed hidden state, float32
  [B, 1], through ``forward_embedding`` (``Engine.encode``);
- ``BaichuanForCausalLM``: RoPE, or ALiBi when the config says
  ``position_embedding: "ALIBI"`` or, leaving it out, has hidden 5120
  (Baichuan2-13B), the JAX class's rule (:144-148): no rope, and
  ``alibi_slopes`` (this module's copy of the JAX schedule) biasing the
  attention, which the aligned head_dim-128 decode and extend carry in an
  ALiBi instantiation of their own;
- ``QWenLMHeadModel``: Llama with a qkv bias;
- ``MiniCPMForCausalLM``: the embedding times ``scale_emb``, each residual
  branch times ``scale_depth / sqrt(L)``, the logits divided by ``hidden /
  dim_model_base``;
- ``XverseMoeForCausalLM``: the Mixtral attention and routing with
  ``norm_topk_prob`` from the config and, where the config has them,
  shared experts added without a gate;
- ``DeepseekForCausalLM``: XverseMoe's MoE on the layers from
  ``first_k_dense_replace`` on (every ``moe_layer_freq``-th), a dense
  gated MLP (``layers.dense_gate_up`` / ``dense_down``) on the others.
  Every layer holds both the dense and the expert stacks, as the JAX tree
  does (:301-317), so that ``load_jax_params`` carries the JAX tree leaf
  for leaf; the layers never read the stacks of the other kind
  (deepseek-moe-16b: about 4.8 GB of such leaves in bf16).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.layers.linear import apply_linear
from semi_pd_tpu_torch.models.llama import LlamaForCausalLM, dtype_scalar
from semi_pd_tpu_torch.models.qwen2_moe import MixtralForCausalLM
from semi_pd_tpu_torch.ops.elementwise import silu_and_mul
from semi_pd_tpu_torch.ops.moe import moe_ffn, route_topk


class InternLM2ForCausalLM(LlamaForCausalLM):
    pass


class InternLM2ForRewardModel(InternLM2ForCausalLM):
    def __init__(self, config: ModelConfig, device):
        config.tie_word_embeddings = True  # no lm_head in the checkpoint
        super().__init__(config, device)
        config.is_embedding = True

    def param_specs(self):
        H = self.config.hidden_size
        return sorted(super().param_specs() + [("v_head.w", (H, 1))])

    def forward_embedding(self, fb, kv_cache: torch.Tensor, attention=None) -> torch.Tensor:
        """The reward: ``v_head`` on each request's last final-normed
        hidden state (``fb.logits_idx``), in the model dtype, then float32
        [B, 1] (the JAX class's forward_embedding)."""
        h = self._final_hidden(fb, kv_cache, attention)[fb.logits_idx.long()]
        return apply_linear(h, self.v_head).float()


class ExaoneForCausalLM(LlamaForCausalLM):
    pass


def alibi_slopes(n_heads: int) -> np.ndarray:
    """ALiBi's slope schedule, float32 [n_heads] (copy of the JAX package's
    llama_variants.py:124-135): powers of 2^(-8 / p) for the largest power
    of two p <= n_heads, then the odd powers of 2^(-4 / p) for the rest."""
    cp2 = 2 ** int(math.floor(math.log2(n_heads)))
    base = 2.0 ** (-(2.0 ** -(math.log2(cp2) - 3)))
    slopes = base ** np.arange(1, 1 + cp2, dtype=np.float64)
    if cp2 != n_heads:
        extra_base = 2.0 ** (-(2.0 ** -(math.log2(2 * cp2) - 3)))
        n_rem = min(cp2, n_heads - cp2)
        extra = extra_base ** np.arange(1, 1 + 2 * n_rem, 2, dtype=np.float64)
        slopes = np.concatenate([slopes, extra])
    return slopes.astype(np.float32)


class BaichuanForCausalLM(LlamaForCausalLM):
    def __init__(self, config: ModelConfig, device):
        super().__init__(config, device)
        pos = config.position_embedding
        if pos == "ALIBI" or (pos is None and config.hidden_size == 5120):
            self.no_rope = True
            self.alibi_slopes = torch.from_numpy(
                alibi_slopes(config.num_attention_heads)).to(device)


class QWenLMHeadModel(LlamaForCausalLM):
    def __init__(self, config: ModelConfig, device):
        config.attention_bias = True  # c_attn carries a fused qkv bias
        super().__init__(config, device)


class MiniCPMForCausalLM(LlamaForCausalLM):
    def __init__(self, config: ModelConfig, device):
        super().__init__(config, device)
        c = config
        self.embed_scale = dtype_scalar(float(c.scale_emb or 1.0), self.dtype)
        self.residual_mult = dtype_scalar(
            float(c.scale_depth or 1.0) / math.sqrt(c.num_hidden_layers), self.dtype)
        if c.dim_model_base:
            self.logits_div = dtype_scalar(c.hidden_size / float(c.dim_model_base),
                                           torch.float32)


class XverseMoeForCausalLM(MixtralForCausalLM):
    NORM_TOPK_FROM_CONFIG = True

    def _mlp_specs(self):
        # the shared experts carry no gate
        return [s for s in super()._mlp_specs() if s[0] != "layers.shared.gate.w"]

    def _mlp(self, layer: int, x: torch.Tensor) -> torch.Tensor:
        c = self.config
        weights, idx = route_topk(apply_linear(x, self.router[layer]).float(),
                                  c.num_experts_per_tok, norm_topk_prob=c.norm_topk_prob)
        out = moe_ffn(x, self.experts_gate_up[layer], self.experts_down[layer], weights, idx)
        if c.num_shared_experts:
            out = out + apply_linear(silu_and_mul(apply_linear(x, self.shared_gate_up[layer])),
                                     self.shared_down[layer])
        return out


class DeepseekForCausalLM(XverseMoeForCausalLM):
    def _is_moe_layer(self, layer: int) -> bool:
        c = self.config
        return (c.num_experts is not None and layer >= c.first_k_dense_replace
                and layer % c.moe_layer_freq == 0)

    def _mlp_specs(self):
        c = self.config
        L, H, I = c.num_hidden_layers, c.hidden_size, c.intermediate_size
        return super()._mlp_specs() + [("layers.dense_down.w", (L, I, H)),
                                       ("layers.dense_gate_up.w", (L, H, 2 * I))]

    def _mlp(self, layer: int, x: torch.Tensor) -> torch.Tensor:
        if not self._is_moe_layer(layer):
            return apply_linear(self.act(apply_linear(x, self.dense_gate_up[layer])),
                                self.dense_down[layer])
        return super()._mlp(layer, x)
