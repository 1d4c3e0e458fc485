"""MiniCPM3 (port of semi_pd_tpu/models/llama_variants.py:343
MiniCPM3ForCausalLM): DeepSeek-V2's absorbed MLA attention with a dense SiLU
MLP, served over the latent pool, and four changes, all set here on a
``DeepseekV2ForCausalLM``:

- the embedding times ``scale_emb``;
- each residual branch (attention and MLP) times ``scale_depth /
  sqrt(num_hidden_layers)``;
- the logits divided by ``hidden_size / dim_model_base``;
- NeoX-style rope on the decoupled pe head (DeepSeek's is interleaved).

The parameter tree is DeepSeek-V2's dense one, leaf for leaf, so
``load_jax_params`` / ``params_tree`` carry the JAX model's weights across.
At MiniCPM3-4B's widths (kv_lora 256 + rope 32) the latent row is 288 wide
with V its first 256, which the latent kernels' _288 builds serve.
"""

from __future__ import annotations

import math

from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.models.deepseek_v2 import DeepseekV2ForCausalLM


class MiniCPM3ForCausalLM(DeepseekV2ForCausalLM):
    def __init__(self, config: ModelConfig, device):
        # the JAX wrapper's defaults where the config leaves a scaling out
        dmb = config.dim_model_base
        super().__init__(
            config, device,
            embed_scale=float(config.scale_emb or 1.0),
            residual_mult=float(config.scale_depth or 1.0)
            / math.sqrt(config.num_hidden_layers),
            logits_div=config.hidden_size / float(dmb) if dmb else None,
            rope_neox=True,
        )
