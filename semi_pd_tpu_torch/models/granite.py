"""IBM Granite (port of semi_pd_tpu/models/granite.py): Llama with four
multipliers from the config, each the JAX class's default where the config
leaves it out: the embedding times ``embedding_multiplier`` (1), the
attention scale ``attention_multiplier`` (head_dim ** -0.5), both residual
branches times ``residual_multiplier`` (1), the logits divided by
``logits_scaling`` (1)."""

from __future__ import annotations

import torch

from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.models.llama import LlamaForCausalLM, dtype_scalar


class GraniteForCausalLM(LlamaForCausalLM):
    def __init__(self, config: ModelConfig, device):
        super().__init__(config, device)
        c = config
        self.embed_scale = dtype_scalar(c.embedding_multiplier or 1.0, self.dtype)
        self.scale = c.attention_multiplier or self.head_dim ** -0.5
        self.residual_mult = dtype_scalar(c.residual_multiplier or 1.0, self.dtype)
        self.logits_div = dtype_scalar(c.logits_scaling or 1.0, torch.float32)
