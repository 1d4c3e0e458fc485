"""Grok-1 (port of semi_pd_tpu/models/grok.py): the Mixtral attention and
experts (models/qwen2_moe.py) with Grok-1's changes, each the JAX class's
default where the config leaves it out:

- sandwich norms: each branch's output (attention, then the experts) normed
  before its residual add (``layers.post_attn_sandwich``,
  ``layers.post_moe_sandwich``; the checkpoint's pre-attention and pre-MoE
  norms are Llama's ``input_norm`` and ``post_norm``);
- the router's float32 logits capped by ``router_logit_softcapping`` (30)
  as cap * tanh(x / cap), then a top-k with no renormalization
  (``norm_topk_prob`` False, written back into the config);
- GELU-gated experts (``moe_ffn``'s ``act``);
- the attention softcap ``attn_logit_softcapping`` (30), written into the
  config's ``attn_logit_softcap``, which the kernels apply;
- the embedding times ``embedding_multiplier_scale`` (1), the logits
  divided by ``1 / output_multiplier_scale`` (1).

Grok-1's 48 query heads over 8 KV heads (G = 6) run the aligned builds
with their rows packed m = r * 6 + g.
"""

from __future__ import annotations

import torch

from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.layers.linear import apply_linear
from semi_pd_tpu_torch.models.llama import dtype_scalar
from semi_pd_tpu_torch.models.qwen2_moe import MixtralForCausalLM
from semi_pd_tpu_torch.ops.elementwise import gelu_and_mul
from semi_pd_tpu_torch.ops.moe import moe_ffn, route_topk


class Grok1ForCausalLM(MixtralForCausalLM):
    NORM_TOPK_FROM_CONFIG = True

    def __init__(self, config: ModelConfig, device):
        c = config
        c.norm_topk_prob = False
        c.attn_logit_softcap = float(30.0 if c.attn_logit_softcapping is None
                                     else c.attn_logit_softcapping)
        super().__init__(config, device)
        self.router_softcap = float(30.0 if c.router_logit_softcapping is None
                                    else c.router_logit_softcapping)
        self.embed_scale = dtype_scalar(float(c.embedding_multiplier_scale or 1.0), self.dtype)
        oms = float(1.0 if c.output_multiplier_scale is None else c.output_multiplier_scale)
        self.logits_div = dtype_scalar(1.0 / oms, torch.float32) if oms else None

    def param_specs(self):
        c = self.config
        L, H = c.num_hidden_layers, c.hidden_size
        return sorted(super().param_specs() + [("layers.post_attn_sandwich", (L, H)),
                                               ("layers.post_moe_sandwich", (L, H))])

    def _layer(self, layer: int, h: torch.Tensor, fb, kv_cache, attention) -> torch.Tensor:
        eps = self.config.rms_norm_eps
        attn = self._attn(layer, self.norm_fn(h, self.input_norm[layer], eps), fb, kv_cache,
                          attention)
        h = h + self.norm_fn(attn, self.post_attn_sandwich[layer], eps)
        moe = self._mlp(layer, self.norm_fn(h, self.post_norm[layer], eps))
        return h + self.norm_fn(moe, self.post_moe_sandwich[layer], eps)

    def _mlp(self, layer: int, x: torch.Tensor) -> torch.Tensor:
        c = self.config
        logits = apply_linear(x, self.router[layer]).float()
        cap = self.router_softcap
        if cap:
            logits = cap * torch.tanh(logits / cap)
        weights, idx = route_topk(logits, c.num_experts_per_tok, norm_topk_prob=False)
        return moe_ffn(x, self.experts_gate_up[layer], self.experts_down[layer], weights, idx,
                       act=gelu_and_mul)
