"""Llama-family causal LM (dense decoder, GQA, RoPE, SiLU-gated MLP): port of
semi_pd_tpu/models/llama.py::LlamaForCausalLM for the main path.

An ``nn.Module`` whose per-layer weights are stacked on a leading [L, ...]
axis, leaf for leaf the JAX package's parameter tree: ``init_params(seed)``
draws the same numbers as the JAX ``init_params``, and ``load_jax_params``
carries a JAX parameter tree (numpy leaves) into the module
(models/params.py; the runner's random weights come from
model_loader/loader.py::device_init_params instead). Linear weights are
[din, dout]. The forward pass updates the KV pool, chunked or aligned, in
place. qkv bias, q/k norms, LoRA, other families and
tensor parallelism are ROADMAP A13-A15.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.layers.attention import paged_attention
from semi_pd_tpu_torch.layers.linear import apply_linear, lm_head_logits
from semi_pd_tpu_torch.models.params import TreeParams
from semi_pd_tpu_torch.ops.elementwise import ACT2FN, rms_norm
from semi_pd_tpu_torch.ops.rope import RotaryEmbedding

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# JAX tree path -> module attribute
_ATTR = {
    "embed.w": "embed",
    "final_norm": "final_norm",
    "layers.down.w": "down",
    "layers.gate_up.w": "gate_up",
    "layers.input_norm": "input_norm",
    "layers.o_proj.w": "o_proj",
    "layers.post_attn_norm": "post_attn_norm",  # Gemma-2's sandwich norms
    "layers.post_ffw_norm": "post_ffw_norm",
    "layers.post_norm": "post_norm",
    "layers.pre_ffw_norm": "pre_ffw_norm",
    "layers.qkv_proj.w": "qkv_proj",
    "lm_head.w": "lm_head",
}


class LlamaForCausalLM(TreeParams):
    def __init__(self, config: ModelConfig, device):
        super().__init__()
        c = self.config = config
        if c.attention_bias:
            raise NotImplementedError("qkv bias (qwen2-style) is ROADMAP A14")
        if c.hidden_act not in ACT2FN:
            raise NotImplementedError(f"activation {c.hidden_act!r} is ROADMAP A14")
        if c.dtype not in DTYPES:
            raise ValueError(f"model dtype {c.dtype!r}: bfloat16 or float32")
        self.num_heads = c.num_attention_heads
        self.num_kv_heads = c.num_key_value_heads
        self.head_dim = c.head_dim
        self.q_size = self.num_heads * self.head_dim
        self.kv_size = self.num_kv_heads * self.head_dim
        self.scale = self.head_dim ** -0.5
        self.dtype = DTYPES[c.dtype]
        self.act = ACT2FN[c.hidden_act]
        self.page_size = 16  # set by the runner: a property of the pool
        # each layer's sliding window (None: full attention)
        self.layer_windows = [c.sliding_window] * c.num_hidden_layers
        self.rope = RotaryEmbedding(
            head_dim=self.head_dim,
            rotary_dim=int(self.head_dim * c.partial_rotary_factor),
            max_position=c.context_length,
            theta=c.rope_theta,
            rope_scaling=c.rope_scaling,
        ).to(device)
        for path, shape in self.param_specs():
            setattr(self, _ATTR[path], torch.nn.Parameter(
                torch.zeros(shape, dtype=self.dtype, device=device),
                requires_grad=False))
        if c.tie_word_embeddings:
            self.lm_head = None

    # ------------------------------------------------------------- params
    def param_specs(self) -> List[Tuple[str, Tuple[int, ...]]]:
        """(JAX tree path, shape) of every leaf, in the order jax.tree.map
        visits the JAX package's parameter tree (sorted dict keys)."""
        c = self.config
        L, H, I = c.num_hidden_layers, c.hidden_size, c.intermediate_size
        specs = [
            ("embed.w", (c.vocab_size, H)),
            ("final_norm", (H,)),
            ("layers.down.w", (L, I, H)),
            ("layers.gate_up.w", (L, H, 2 * I)),
            ("layers.input_norm", (L, H)),
            ("layers.o_proj.w", (L, self.q_size, H)),
            ("layers.post_norm", (L, H)),
            ("layers.qkv_proj.w", (L, H, self.q_size + 2 * self.kv_size)),
        ]
        if not c.tie_word_embeddings:
            specs.append(("lm_head.w", (H, c.vocab_size)))
        return specs

    def leaf(self, path: str) -> torch.nn.Parameter:
        """The parameter of JAX tree path ``path`` (e.g. "layers.qkv_proj.w")."""
        return getattr(self, _ATTR[path])

    # ------------------------------------------------------------- forward
    def forward(self, fb, kv_cache: torch.Tensor, attention=None, return_hidden: bool = False,
                all_logits: bool = False):
        """One step over the flat batch ``fb``; writes this step's K/V into
        ``kv_cache`` (chunked [L, S, CT, 128] or aligned [L, 2, S, Hkv, D])
        and returns float32 logits [B, V] of the rows ``fb.logits_idx``
        picks (each request's last token; every row of a speculative verify
        batch), or with ``all_logits`` of every flat token row [T, V]
        (input-logprob scoring). ``attention`` runs over the pool after each
        layer's KV write (default: the pool layout's routing to the
        kernels). ``return_hidden``: also return those rows' final-normed
        hidden states in the model dtype, (logits, hidden), the state that
        seeds the EAGLE draft (JAX ``return_hidden``)."""
        h = self._final_hidden(fb, kv_cache, attention)
        last_h = h if all_logits else h[fb.logits_idx.long()]
        logits = lm_head_logits(last_h, self.head(), self.config.logit_softcap)
        return (logits, last_h) if return_hidden else logits

    def forward_embedding(self, fb, kv_cache: torch.Tensor, attention=None) -> torch.Tensor:
        """Pooled sequence embedding: the final-normed hidden state of each
        request's last token (``fb.logits_idx``), float32 [B, H], divided by
        its L2 norm (at least 1e-12), as the JAX model's forward_embedding."""
        emb = self._final_hidden(fb, kv_cache, attention)[fb.logits_idx.long()].float()
        return emb / torch.clamp(torch.linalg.vector_norm(emb, dim=-1, keepdim=True),
                                 min=1e-12)

    def _final_hidden(self, fb, kv_cache, attention) -> torch.Tensor:
        """Every flat row's hidden state after the last layer and the final
        norm [T, H], in the model dtype."""
        c = self.config
        h = self.embed[fb.input_ids.long()]
        for layer in range(c.num_hidden_layers):
            attn_in = rms_norm(h, self.input_norm[layer], c.rms_norm_eps)
            h = h + self._attn(layer, attn_in, fb, kv_cache, attention)
            mlp_in = rms_norm(h, self.post_norm[layer], c.rms_norm_eps)
            h = h + apply_linear(self.act(apply_linear(mlp_in, self.gate_up[layer])),
                                 self.down[layer])
        return rms_norm(h, self.final_norm, c.rms_norm_eps)

    def head(self) -> torch.Tensor:
        """The lm_head [H, V] (the embedding's transpose when tied)."""
        return self.lm_head if self.lm_head is not None else self.embed.t()

    def _attn(self, layer, attn_in, fb, kv_cache, attention):
        c = self.config
        T = attn_in.shape[0]
        qkv = apply_linear(attn_in, self.qkv_proj[layer])
        q, k, v = qkv.split([self.q_size, self.kv_size, self.kv_size], dim=-1)
        q = q.reshape(T, self.num_heads, self.head_dim)
        k = k.reshape(T, self.num_kv_heads, self.head_dim)
        v = v.reshape(T, self.num_kv_heads, self.head_dim)
        q, k = self.rope(fb.q_pos, q, k)
        out = paged_attention(
            q, k, v, kv_cache, layer, fb, page_size=self.page_size,
            scale=self.scale, logit_cap=c.attn_logit_softcap,
            sliding_window=self.layer_windows[layer], attention=attention,
        )
        return apply_linear(out.reshape(T, self.q_size), self.o_proj[layer])
