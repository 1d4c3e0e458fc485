"""The LayerNorm families (port of semi_pd_tpu/models/layernorm_families.py):
StableLM, Starcoder2, Phi, Cohere, OLMo-2 and Phi-3-small, each the Llama
block (models/llama.py) with another mix of norm, biases and topology,
set through Llama's hooks, leaf for leaf the JAX classes':

- ``NonGatedMLPMixin``: the fc1 -> act -> fc2 MLP (``layers.fc1`` /
  ``layers.fc2``, each with a bias unless ``MLP_BIAS`` is off), its
  activation ``mlp_act`` (GELU's tanh form unless a class picks another);
- ``StableLmForCausalLM``: Llama's gated MLP, LayerNorm with bias, partial
  rotary (``partial_rotary_factor``, 0.25 by default: ModelConfig reads it),
  a qkv bias behind ``use_qkv_bias``;
- ``Starcoder2ForCausalLM``: GQA with rope and its window, LayerNorm with
  bias, the non-gated MLP, a bias on every linear behind ``use_bias``;
- ``PhiForCausalLM``: attention and MLP in parallel from one LayerNorm,
  partial rotary (0.5 by default), biases on qkv, dense and the lm_head;
- ``CohereForCausalLM``: the parallel block, a bias-free LayerNorm
  (weight-only leaves), GPT-J interleaved rope, tied embeddings, the
  logits divided by ``1 / logit_scale``;
- ``Olmo2ForCausalLM``: the norms on the branch outputs (``input_norm``
  after the attention, ``post_norm`` after the MLP, the residual stream
  un-normed into both) and RMSNorm q / k over the full projections;
- ``Phi3SmallForCausalLM``: LayerNorm with bias, biases on qkv, dense and
  the MLP (``layers.gate_up.b``, ``layers.down.b``), μP (the attention
  scale ``mup_attn_multiplier / head_dim``, the embedding times
  ``mup_embedding_multiplier``, the logits divided by
  ``mup_width_multiplier``), the gegelu MLP over contiguous halves with its
  limit, and ``logit_bias`` masking the tokenizer's dummy tokens. Dense
  attention: the JAX class serves it so (its blocksparse settings are
  never passed to the attention, :201-206).

What each JAX class reads from its HF config when it is built is a
ModelConfig field of the key's own name (``config/model_config.py``
BUILD_KEYS), and its side effects on the config (qkv and o_proj biases,
tied embeddings) are made here on the port's config, as the JAX classes
make them on theirs. Loading by the checkpoints' names (``MLP_FC1`` and
the classes' ``hf_weight_plan``, Phi-3-small's interleaved
``query_key_value`` and ``up_proj``) waits for ROADMAP A13.
"""

from __future__ import annotations

import numpy as np
import torch

from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.layers.linear import apply_linear
from semi_pd_tpu_torch.models.llama import LlamaForCausalLM, dtype_scalar
from semi_pd_tpu_torch.ops.elementwise import PLAIN_ACT, gelu_tanh, layer_norm


class NonGatedMLPMixin:
    """fc1 -> act -> fc2 (no gate); ``MLP_FC1`` / ``MLP_FC2`` name the
    checkpoint's tensors (A13)."""

    MLP_FC1 = "mlp.fc1"
    MLP_FC2 = "mlp.fc2"
    MLP_BIAS = True
    ACT_FROM_CONFIG = False
    mlp_act = staticmethod(gelu_tanh)

    def _mlp_specs(self):
        c = self.config
        L, H, I = c.num_hidden_layers, c.hidden_size, c.intermediate_size
        specs = [("layers.fc1.w", (L, H, I)), ("layers.fc2.w", (L, I, H))]
        if self.MLP_BIAS:
            specs += [("layers.fc1.b", (L, I)), ("layers.fc2.b", (L, H))]
        return specs

    def _mlp(self, layer: int, x: torch.Tensor) -> torch.Tensor:
        b1, b2 = (self.fc1_b[layer], self.fc2_b[layer]) if self.MLP_BIAS else (None, None)
        return apply_linear(self.mlp_act(apply_linear(x, self.fc1[layer], b1)),
                            self.fc2[layer], b2)


class StableLmForCausalLM(LlamaForCausalLM):
    NORM_BIAS = True

    def __init__(self, config: ModelConfig, device):
        config.attention_bias = bool(config.use_qkv_bias)
        super().__init__(config, device)
        self.norm_fn = layer_norm


class Starcoder2ForCausalLM(NonGatedMLPMixin, LlamaForCausalLM):
    MLP_FC1 = "mlp.c_fc"
    MLP_FC2 = "mlp.c_proj"
    NORM_BIAS = True

    def __init__(self, config: ModelConfig, device):
        use_bias = config.use_bias is not False  # True where the config leaves it out
        config.attention_bias = config.o_proj_bias = use_bias
        super().__init__(config, device)
        self.norm_fn = layer_norm
        tanh = config.hidden_act in ("gelu_new", "gelu_pytorch_tanh")
        self.mlp_act = PLAIN_ACT["gelu_new" if tanh else "gelu"]

    @property
    def MLP_BIAS(self):  # noqa: N802 (the mixin's class attribute, from the config)
        return self.config.use_bias is not False


class PhiForCausalLM(NonGatedMLPMixin, LlamaForCausalLM):
    NORM_BIAS = True
    PARALLEL_BLOCK = True
    LM_HEAD_BIAS = True

    def __init__(self, config: ModelConfig, device):
        config.attention_bias = config.o_proj_bias = True
        super().__init__(config, device)
        self.norm_fn = layer_norm


class CohereForCausalLM(LlamaForCausalLM):
    PARALLEL_BLOCK = True
    ROPE_NEOX = False

    def __init__(self, config: ModelConfig, device):
        config.tie_word_embeddings = True
        super().__init__(config, device)
        self.norm_fn = layer_norm  # weight-only leaves: LayerNorm without bias
        scale = 1.0 if config.logit_scale is None else config.logit_scale
        self.logits_div = dtype_scalar(1.0 / scale, torch.float32)


class Olmo2ForCausalLM(LlamaForCausalLM):
    QK_NORM_FULL = True

    def _layer(self, layer: int, h: torch.Tensor, fb, kv_cache, attention) -> torch.Tensor:
        """The branch outputs normed before their residual adds: ``input_norm``
        after the attention (HF's post_attention_layernorm), ``post_norm``
        after the MLP (post_feedforward_layernorm)."""
        eps = self.config.rms_norm_eps
        attn = self._attn(layer, h, fb, kv_cache, attention)
        h = h + self.norm_fn(attn, self.input_norm[layer], eps)
        return h + self.norm_fn(self._mlp(layer, h), self.post_norm[layer], eps)


class Phi3SmallForCausalLM(LlamaForCausalLM):
    NORM_BIAS = True
    ACT_FROM_CONFIG = False  # "gegelu"

    def __init__(self, config: ModelConfig, device):
        c = config
        c.attention_bias = c.o_proj_bias = True
        super().__init__(config, device)
        self.norm_fn = layer_norm
        if c.mup_use_scaling:
            self.scale = float(c.mup_attn_multiplier) / self.head_dim
        if c.mup_embedding_multiplier:
            self.embed_scale = dtype_scalar(float(c.mup_embedding_multiplier), self.dtype)
        if c.mup_width_multiplier and c.mup_width_multiplier != 1.0:
            # HF's remote code divides the logits by it (the JAX class keeps it)
            self.logits_div = dtype_scalar(float(c.mup_width_multiplier), torch.float32)
        self.gegelu_limit = c.gegelu_limit
        if c.dummy_token_indices:
            bias = np.zeros(c.vocab_size, np.float32)
            bias[np.asarray(c.dummy_token_indices)] = -1e30
            self.logit_bias = torch.from_numpy(bias).to(device)

    def _mlp_specs(self):
        c = self.config
        L, H = c.num_hidden_layers, c.hidden_size
        return sorted(super()._mlp_specs() + [("layers.down.b", (L, H)),
                                              ("layers.gate_up.b", (L, 2 * c.intermediate_size))])

    def gegelu(self, gu: torch.Tensor) -> torch.Tensor:
        """g * sigmoid(1.702 g) * (u + 1) over the contiguous halves [g | u]
        (the checkpoint's interleaved channels are de-interleaved at load),
        g capped above and u clipped to +-gegelu_limit where it is set."""
        g, u = gu.chunk(2, dim=-1)
        lim = self.gegelu_limit
        if lim is not None:
            g = torch.clamp(g, max=lim)
            u = torch.clamp(u, -lim, lim)
        return g * torch.sigmoid(1.702 * g) * (u + 1.0)

    def _mlp(self, layer: int, x: torch.Tensor) -> torch.Tensor:
        gu = apply_linear(x, self.gate_up[layer], self.gate_up_b[layer])
        return apply_linear(self.gegelu(gu), self.down[layer], self.down_b[layer])
