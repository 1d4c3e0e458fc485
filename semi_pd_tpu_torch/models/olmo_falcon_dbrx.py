"""OLMo-1, Falcon (7B-style) and DBRX (port of semi_pd_tpu/models/
olmo_falcon_dbrx.py), three more sets of the Llama hooks:

- ``OlmoForCausalLM``: Llama with a LayerNorm without parameters (its
  tree keeps the norms' placeholder leaves, unread), eps 1e-5, and the
  fused qkv clipped to +-``clip_qkv`` where the config sets it;
- ``FalconForCausalLM``: one LayerNorm (with bias) feeding attention and
  MLP in parallel (``parallel_attn``, on by default), multi-query
  attention (``ModelConfig.from_hf_config`` sets one KV head), the
  non-gated exact-GELU MLP ``dense_h_to_4h`` / ``dense_4h_to_h`` at 4 x
  hidden, with biases only under ``bias``. ``new_decoder_architecture``
  (Falcon-40B / 180B) and ``alibi`` are refused, as the JAX class refuses
  them;
- ``DbrxForCausalLM``: the Mixtral attention and experts
  (models/qwen2_moe.py) with the top-k weights renormalized by the config
  (``norm_topk_prob``, which ``from_hf_config`` sets), a bias-free
  LayerNorm (weight-only leaves) and ``clip_qkv`` from its ``attn_config``.

Falcon-7B's one KV head at head_dim 64 is a 64-element slot row on the 5D
pool, which the merged builds serve (runtime/model_runner.py
kv_pool_layout), its 71 query heads in five head groups (16 x 4 + 7) of
the tensor-core decodes (csrc/rpa_decode_mma.cuh mma_head_group).
"""

from __future__ import annotations

from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.models.layernorm_families import NonGatedMLPMixin
from semi_pd_tpu_torch.models.llama import LlamaForCausalLM
from semi_pd_tpu_torch.models.qwen2_moe import MixtralForCausalLM
from semi_pd_tpu_torch.ops.elementwise import gelu_exact, layer_norm, plain_layer_norm


class OlmoForCausalLM(LlamaForCausalLM):
    def __init__(self, config: ModelConfig, device):
        config.rms_norm_eps = 1e-5  # F.layer_norm's default in HF's OLMo
        super().__init__(config, device)
        self.norm_fn = plain_layer_norm
        self.qkv_clip = config.clip_qkv


class FalconForCausalLM(NonGatedMLPMixin, LlamaForCausalLM):
    MLP_FC1 = "mlp.dense_h_to_4h"
    MLP_FC2 = "mlp.dense_4h_to_h"
    NORM_BIAS = True
    mlp_act = staticmethod(gelu_exact)

    def __init__(self, config: ModelConfig, device):
        if config.new_decoder_architecture:
            raise NotImplementedError(
                "Falcon's new_decoder_architecture (Falcon-40B / 180B: grouped KV heads, two "
                "input norms) is not served by the JAX package's class nor the port's; "
                "ROADMAP A14")
        if config.alibi:
            raise NotImplementedError(
                "Falcon with ALiBi positions is not served by the JAX package's class nor "
                "the port's (the port's ALiBi builds, B9.6); ROADMAP A14")
        config.intermediate_size = 4 * config.hidden_size
        super().__init__(config, device)
        self.norm_fn = layer_norm

    @property
    def PARALLEL_BLOCK(self):  # noqa: N802 (Llama's class attribute, from the config)
        return self.config.parallel_attn is not False

    @property
    def MLP_BIAS(self):  # noqa: N802 (the mixin's class attribute, from the config)
        return bool(self.config.bias)


class DbrxForCausalLM(MixtralForCausalLM):
    NORM_TOPK_FROM_CONFIG = True

    def __init__(self, config: ModelConfig, device):
        super().__init__(config, device)
        self.norm_fn = layer_norm  # weight-only leaves: LayerNorm without bias
        self.qkv_clip = config.clip_qkv
