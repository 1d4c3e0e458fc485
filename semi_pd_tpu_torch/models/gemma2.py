"""Gemma-2 and Gemma-1 (port of semi_pd_tpu/models/gemma2.py: ``:35
Gemma2ForCausalLM`` and ``:132 GemmaForCausalLM``).

Gemma-2 is the Llama decoder with Gemma-2's changes, all set here on a
``LlamaForCausalLM``:

- RMSNorm in float32 times ``(1 + w)``, then cast (``gemma_rms``);
- the embedding times ``sqrt(hidden_size)``, the scale rounded to the model
  dtype first;
- sandwich norms: each block's output (attention, then MLP) is normed
  before its residual add (``post_attn_norm``, ``post_ffw_norm``), the MLP's
  input by ``pre_ffw_norm``;
- attention scale ``query_pre_attn_scalar ** -0.5``;
- the attention softcap on every layer and the final logit softcap;
- a sliding window on the layers ``layer_types`` marks (by default the
  even ones), full attention on the others;
- GeGLU with GELU's tanh approximation, and tied embeddings.

What the JAX model reads from the HF config with defaults are ModelConfig
fields here, each with the JAX default where it is None, set in
``__init__``: ``query_pre_attn_scalar`` (head_dim), ``attn_logit_softcap``
(50.0), ``logit_softcap`` (30.0), ``sliding_window`` (4096) and
``layer_types`` (even layers sliding). The softcaps are written back into
the config, as the JAX model writes them.

The parameter tree is the JAX model's, leaf for leaf: Llama's, tied, plus
``layers.post_attn_norm``, ``layers.post_ffw_norm`` and
``layers.pre_ffw_norm``. It keeps Llama's ``layers.post_norm``, which the
JAX layer never reads (semi_pd_tpu/models/llama.py:140-141), so that
``init_params(seed)`` draws the JAX numbers in the JAX order and
``load_jax_params`` carries a JAX tree across. At Gemma-2's head_dim 256
the runner puts KV in the 5D pool ``[L, 2, S, Hkv, 256]``, which the GQA
kernels' ``_256`` builds serve.

Gemma-1 is Llama's block and parameter tree (tied: no lm_head) with
Gemma's conventions set through Llama's hooks: every norm ``gemma_rms``,
the embedding times ``sqrt(hidden_size)`` rounded to the model dtype,
GeGLU and the scale ``query_pre_attn_scalar ** -0.5`` (head_dim's when
None); no sandwich norms and no softcaps. Its attention takes the config's
``sliding_window`` on every layer, as the JAX class, whose layer is
Llama's, does (Gemma-7B's config sets none). Gemma-7B is multi-head at
head_dim 256 (16 / 16): the ``_256`` builds at one query head per KV head.
"""

from __future__ import annotations

import math

import torch

from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.layers.linear import apply_linear
from semi_pd_tpu_torch.models.llama import LlamaForCausalLM
from semi_pd_tpu_torch.ops.elementwise import gelu_and_mul

# the JAX model's defaults for what a config leaves out (gemma2.py:40-53)
DEFAULT_ATTN_SOFTCAP = 50.0
DEFAULT_FINAL_SOFTCAP = 30.0
DEFAULT_SLIDING_WINDOW = 4096


def embed_scale(hidden_size: int, dtype: torch.dtype) -> float:
    """sqrt(hidden_size) rounded to the model dtype, as the JAX models round
    it (gemma2.py:95), kept as a Python number: a step replayed from a CUDA
    graph makes no tensor from the host."""
    return float(torch.tensor(math.sqrt(hidden_size)).to(dtype))


def gemma_rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in float32 with Gemma's (1 + w) weight, cast back to x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * (1.0 + w.float())).to(x.dtype)


class Gemma2ForCausalLM(LlamaForCausalLM):
    def __init__(self, config: ModelConfig, device):
        config.tie_word_embeddings = True
        super().__init__(config, device)
        c = config
        self.scale = (c.query_pre_attn_scalar or self.head_dim) ** -0.5
        if c.attn_logit_softcap is None:
            c.attn_logit_softcap = DEFAULT_ATTN_SOFTCAP
        if c.logit_softcap is None:
            c.logit_softcap = DEFAULT_FINAL_SOFTCAP
        window = DEFAULT_SLIDING_WINDOW if c.sliding_window is None else c.sliding_window
        if c.layer_types:
            if len(c.layer_types) != c.num_hidden_layers:
                raise ValueError(f"{len(c.layer_types)} layer_types for "
                                 f"{c.num_hidden_layers} layers")
            sliding = [t == "sliding_attention" for t in c.layer_types]
        else:
            sliding = [i % 2 == 0 for i in range(c.num_hidden_layers)]
        self.layer_windows = [window if s else None for s in sliding]
        self.act = gelu_and_mul
        self.embed_scale = embed_scale(c.hidden_size, self.dtype)

    def param_specs(self):
        """Llama's leaves (tied: no lm_head) and the three sandwich norms,
        in the JAX tree's order: its dict keys sorted at every level, which
        for these paths is their sorted order."""
        c = self.config
        L, H = c.num_hidden_layers, c.hidden_size
        norms = [(f"layers.{n}", (L, H))
                 for n in ("post_attn_norm", "post_ffw_norm", "pre_ffw_norm")]
        return sorted(super().param_specs() + norms)

    def _final_hidden(self, fb, kv_cache, attention) -> torch.Tensor:
        """As LlamaForCausalLM's, with Gemma-2's block: the scaled
        embedding, every norm gemma_rms, the sandwich norms, each layer's
        own window."""
        c = self.config
        eps = c.rms_norm_eps
        h = self.embed[fb.input_ids.long()]
        h = h * self.embed_scale
        for layer in range(c.num_hidden_layers):
            attn = self._attn(layer, gemma_rms(h, self.input_norm[layer], eps), fb, kv_cache,
                              attention)
            h = h + gemma_rms(attn, self.post_attn_norm[layer], eps)
            y = gemma_rms(h, self.pre_ffw_norm[layer], eps)
            mlp = apply_linear(self.act(apply_linear(y, self.gate_up[layer])), self.down[layer])
            h = h + gemma_rms(mlp, self.post_ffw_norm[layer], eps)
        return gemma_rms(h, self.final_norm, eps)


class GemmaForCausalLM(LlamaForCausalLM):
    def __init__(self, config: ModelConfig, device):
        config.tie_word_embeddings = True
        config.attn_logit_softcap = config.logit_softcap = None
        super().__init__(config, device)
        self.scale = (config.query_pre_attn_scalar or self.head_dim) ** -0.5
        self.act = gelu_and_mul
        self.norm_fn = gemma_rms
        self.embed_scale = embed_scale(config.hidden_size, self.dtype)
