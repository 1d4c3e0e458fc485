"""The GLM family (port of semi_pd_tpu/models/glm.py): Glm, Glm4 and
ChatGLM, each Llama's block and parameter tree with GLM's rope, GPT-J
interleaved pairs over the first ``partial_rotary_factor`` of head_dim
(``ROPE_NEOX = False``; ChatGLM's ``from_hf_config`` clause sets the
factor to 0.5 and the base to ``10000 * rope_ratio``).

- ``GlmForCausalLM``: the HF-format GLM (its fused gate_up checkpoint is
  ROADMAP A13);
- ``Glm4ForCausalLM``: Glm with sandwich norms, each branch's output
  (attention, then MLP) normed before its residual add
  (``layers.post_attn_sandwich``, ``layers.post_mlp_sandwich``);
- ``ChatGLMForCausalLM``: ChatGLM 2 / 3 and GLM-4's first checkpoints, a
  qkv bias unless the config turns off both ``add_qkv_bias`` (default on)
  and ``add_bias_linear`` (default off), as the JAX class sets it. Its
  ``ChatGLMModel`` string serves generation here as in the JAX registry.
  ChatGLM3-6B and GLM-4-9B run 32 query heads over 2 KV groups (G = 16),
  which fill the decodes' m16 tile.
"""

from __future__ import annotations

import torch

from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.models.llama import LlamaForCausalLM


class GlmForCausalLM(LlamaForCausalLM):
    ROPE_NEOX = False


class Glm4ForCausalLM(GlmForCausalLM):
    def param_specs(self):
        c = self.config
        L, H = c.num_hidden_layers, c.hidden_size
        return sorted(super().param_specs() + [("layers.post_attn_sandwich", (L, H)),
                                               ("layers.post_mlp_sandwich", (L, H))])

    def _layer(self, layer: int, h: torch.Tensor, fb, kv_cache, attention) -> torch.Tensor:
        eps = self.config.rms_norm_eps
        attn = self._attn(layer, self.norm_fn(h, self.input_norm[layer], eps), fb, kv_cache,
                          attention)
        h = h + self.norm_fn(attn, self.post_attn_sandwich[layer], eps)
        mlp = self._mlp(layer, self.norm_fn(h, self.post_norm[layer], eps))
        return h + self.norm_fn(mlp, self.post_mlp_sandwich[layer], eps)


class ChatGLMForCausalLM(GlmForCausalLM):
    def __init__(self, config: ModelConfig, device):
        qkv = True if config.add_qkv_bias is None else config.add_qkv_bias
        config.attention_bias = bool(qkv or config.add_bias_linear)
        super().__init__(config, device)
