"""Llama-family causal LM (dense decoder, GQA, RoPE, gated MLP): port of
semi_pd_tpu/models/llama.py::LlamaForCausalLM.

One class serves the five strings the JAX registry maps to it
(semi_pd_tpu/models/registry.py:51-58): Llama, Mistral and Xverse are
config only (Mistral's window is ``ModelConfig.sliding_window``), Qwen2
adds a qkv bias (``attention_bias``: the leaf ``layers.qkv_proj.b``) and
Qwen3 a per-head q/k RMSNorm after the head split and before rope
(``layers.q_norm`` / ``layers.k_norm`` [L, head_dim]). The family hooks
the JAX class gives its subclasses are here too: ``QK_NORM_FULL`` (OLMoE:
the norms over the whole q / k projection, [L, q_size] / [L, kv_size],
before the split), ``_mlp_specs`` / ``_mlp`` (the MoE classes'
experts, models/qwen2_moe.py), ``norm_fn`` and ``embed_scale`` (Gemma-1,
models/gemma2.py), and those of the variant classes
(models/llama_variants.py, glm.py, phi3.py, granite.py, grok.py), leaf
for leaf the JAX class's (semi_pd_tpu/models/llama.py):

- ``residual_mult``: both residual branches times it, before their adds
  (MiniCPM, Granite; JAX :342-349);
- ``logits_div``: the float32 logits divided by it after the final softcap
  (MiniCPM, Granite, Grok-1; JAX :297-298);
- ``scale``: the attention scale (Granite's ``attention_multiplier``);
- ``no_rope`` with ``alibi_slopes`` (float32 [Hq]): no rope, ALiBi's bias
  in the attention instead (Baichuan2-13B; JAX :87, :99, :377, :401);
- ``ROPE_NEOX``: the rope's rotation, GPT-J interleaved for the GLM family
  (glm.py:30-39);
- ``_layer``: one decoder layer, which the sandwich-norm classes (Glm4,
  Grok-1) and OLMo-2 replace;
- the LayerNorm families' hooks (models/layernorm_families.py, gpt2.py,
  olmo_falcon_dbrx.py; JAX :80-89, 111-127, 264-267, 299-300, 335-341,
  361-362): ``NORM_BIAS`` (every norm a {"w", "b"} leaf) with ``norm_fn``
  a LayerNorm, weight-only or without parameters (``ops/elementwise.py``);
  ``PARALLEL_BLOCK`` (attention and MLP both from the one input norm, h +
  attn + mlp, no ``post_norm``: Phi, Cohere, Falcon); ``POS_EMBED``
  (learned positions ``pos_embed.w`` [max_position_embeddings, H] added to
  the embedding at ``q_pos``: GPT-2, with ``no_rope``); ``LM_HEAD_BIAS``
  (Phi); ``logit_bias`` (float32 [V] on the device, added after
  ``logits_div``: Phi-3-small's dummy tokens); ``o_proj_bias`` (a config
  field: ``layers.o_proj.b``); ``qkv_clip`` (the fused qkv clipped to
  [-c, c] before the split: OLMo, DBRX); ``ACT_FROM_CONFIG`` False for the
  classes whose MLP does not take ``hidden_act`` (the non-gated fc1 -> act
  -> fc2 MLP of NonGatedMLPMixin, Phi-3-small's gegelu).

The scalars are rounded to the dtype they multiply, as JAX's
``jnp.asarray(v, x.dtype)`` rounds them (``dtype_scalar``).

An ``nn.Module`` whose per-layer weights are stacked on a leading [L, ...]
axis, leaf for leaf the JAX package's parameter tree: ``init_params(seed)``
draws the same numbers as the JAX ``init_params``, and ``load_jax_params``
carries a JAX parameter tree (numpy leaves) into the module
(models/params.py; the runner's random weights come from
model_loader/loader.py::device_init_params instead). Linear weights are
[din, dout]; with ``config.quantization`` the linears and expert stacks
the JAX ``quantize_params`` quantizes are ``QuantWeight`` leaves
(models/params.py ``new_leaf``), indexed by layer as the tensors are. The
forward pass updates the KV pool, chunked or aligned, in place. LoRA, other activations and families, and tensor parallelism are
ROADMAP A13-A15.
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
    "final_norm.b": "final_norm_b",  # the LayerNorm families' {"w", "b"} norms
    "final_norm.w": "final_norm",
    "layers.dense_down.w": "dense_down",  # DeepSeek-V1's dense layers (llama_variants.py)
    "layers.dense_gate_up.w": "dense_gate_up",
    "layers.down.b": "down_b",  # Phi-3-small's
    "layers.down.w": "down",
    "layers.fc1.b": "fc1_b",  # the non-gated MLP's (layernorm_families.py)
    "layers.fc1.w": "fc1",
    "layers.fc2.b": "fc2_b",
    "layers.fc2.w": "fc2",
    "layers.gate_up.b": "gate_up_b",
    "layers.gate_up.w": "gate_up",
    "layers.experts.down": "experts_down",  # the MoE classes' (qwen2_moe.py)
    "layers.experts.gate_up": "experts_gate_up",
    "layers.input_norm": "input_norm",
    "layers.input_norm.b": "input_norm_b",
    "layers.input_norm.w": "input_norm",
    "layers.k_norm": "k_norm",  # Qwen3's per-head, OLMoE's full-width
    "layers.o_proj.b": "o_proj_b",
    "layers.o_proj.w": "o_proj",
    "layers.post_attn_norm": "post_attn_norm",  # Gemma-2's sandwich norms
    "layers.post_attn_sandwich": "post_attn_sandwich",  # Glm4's and Grok-1's
    "layers.post_ffw_norm": "post_ffw_norm",
    "layers.post_mlp_sandwich": "post_mlp_sandwich",
    "layers.post_moe_sandwich": "post_moe_sandwich",
    "layers.post_norm": "post_norm",
    "layers.post_norm.b": "post_norm_b",
    "layers.post_norm.w": "post_norm",
    "layers.pre_ffw_norm": "pre_ffw_norm",
    "layers.q_norm": "q_norm",
    "layers.qkv_proj.b": "qkv_bias",  # Qwen2's
    "layers.qkv_proj.w": "qkv_proj",
    "layers.router.w": "router",
    "layers.shared.down.w": "shared_down",  # Qwen2-MoE's shared expert
    "layers.shared.gate.w": "shared_gate",
    "layers.shared.gate_up.w": "shared_gate_up",
    "lm_head.b": "lm_head_b",  # Phi's
    "lm_head.w": "lm_head",
    "pos_embed.w": "pos_embed",  # GPT-2's learned positions
    "v_head.w": "v_head",  # InternLM2's reward head
    "score.w": "score",  # the sequence classifiers' head (classify.py)
    "score.fc1.b": "score_fc1_b",  # Qwen2's reward head
    "score.fc1.w": "score_fc1",
    "score.fc2.b": "score_fc2_b",
    "score.fc2.w": "score_fc2",
}

# the architectures with Qwen3's per-head q/k RMSNorm (JAX llama.py:65-69)
QK_NORM_ARCHS = ("Qwen3ForCausalLM", "Qwen3MoeForCausalLM")


def splice_embeds(h: torch.Tensor, fb) -> torch.Tensor:
    """``h`` [T, H] with the rows ``fb.embed_rows`` replaced by
    ``fb.embed_vals`` cast to h's dtype (the JAX ``jnp.where(mask,
    override.astype(h.dtype), h)``); ``h`` itself where the batch splices
    nothing."""
    if fb.embed_rows is None:
        return h
    h = h.clone()
    h[fb.embed_rows] = fb.embed_vals.to(h.dtype)
    return h


def dtype_scalar(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype``, as JAX's ``jnp.asarray(v, x.dtype)`` rounds
    a scale before multiplying a tensor of that dtype by it."""
    return torch.tensor(v, dtype=dtype).item()


class LlamaForCausalLM(TreeParams):
    # q/k RMSNorm over the whole projections, before the head split (OLMoE)
    QK_NORM_FULL = False
    # the rope's rotation: GPT-NeoX halves, or GPT-J interleaved pairs (GLM)
    ROPE_NEOX = True
    # the LayerNorm families' structure (module docstring)
    NORM_BIAS = False
    PARALLEL_BLOCK = False
    POS_EMBED = False
    LM_HEAD_BIAS = False
    ACT_FROM_CONFIG = True
    # Qwen2-VL's M-RoPE position ([T, 3] ``fb.mrope_pos``) for the rope
    uses_mrope = False

    def __init__(self, config: ModelConfig, device):
        super().__init__()
        c = self.config = config
        if self.ACT_FROM_CONFIG and c.hidden_act not in ACT2FN:
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
        self.act = ACT2FN.get(c.hidden_act)
        # the family hooks (set before the leaves are made: they shape them)
        self.use_qk_norm = self.QK_NORM_FULL or c.architecture in QK_NORM_ARCHS
        self.norm_fn = rms_norm
        self.embed_scale = None  # a Python number (Gemma: rounded to the dtype)
        self.residual_mult = None  # a Python number in the model dtype
        self.logits_div = None  # a Python number in float32
        self.no_rope = False
        self.qkv_clip = None  # OLMo's and DBRX's clip_qkv
        # float32 [V] added to the logits (Phi-3-small's dummy tokens)
        self.register_buffer("logit_bias", None, persistent=False)
        # ALiBi's slopes, float32 [Hq] on the device (Baichuan2-13B)
        self.register_buffer("alibi_slopes", None, persistent=False)
        self.page_size = 16  # set by the runner: a property of the pool
        # each layer's sliding window (None: full attention)
        self.layer_windows = [c.sliding_window] * c.num_hidden_layers
        self.rope = self.make_rope().to(device)
        for path, shape in self.param_specs():  # quantized leaves: QuantWeight
            setattr(self, _ATTR[path], self.new_leaf(path, shape, self.dtype, device))
        if c.tie_word_embeddings:
            self.lm_head = None

    def make_rope(self) -> RotaryEmbedding:
        """The rope of the config (Qwen2-VL: its M-RoPE)."""
        c = self.config
        return RotaryEmbedding(
            head_dim=self.head_dim,
            rotary_dim=int(self.head_dim * c.partial_rotary_factor),
            max_position=c.context_length,
            theta=c.rope_theta,
            rope_scaling=c.rope_scaling,
            is_neox_style=self.ROPE_NEOX,
        )

    # ------------------------------------------------------------- params
    def param_specs(self) -> List[Tuple[str, Tuple[int, ...]]]:
        """(JAX tree path, shape) of every leaf, in the order jax.tree.map
        visits the JAX package's parameter tree: its dict keys sorted at
        every level, which for these dotted paths is their sorted order."""
        c = self.config
        L, H = c.num_hidden_layers, c.hidden_size
        qkv_out = self.q_size + 2 * self.kv_size
        specs = [
            ("embed.w", (c.vocab_size, H)),
            *self._norm_specs("final_norm", H),
            *self._norm_specs("layers.input_norm", L, H),
            ("layers.o_proj.w", (L, self.q_size, H)),
            ("layers.qkv_proj.w", (L, H, qkv_out)),
            *self._mlp_specs(),
        ]
        if not self.PARALLEL_BLOCK:
            specs += self._norm_specs("layers.post_norm", L, H)
        if c.attention_bias:
            specs.append(("layers.qkv_proj.b", (L, qkv_out)))
        if c.o_proj_bias:
            specs.append(("layers.o_proj.b", (L, H)))
        if self.POS_EMBED:
            specs.append(("pos_embed.w", (c.max_position_embeddings, H)))
        if self.use_qk_norm:
            full = self.QK_NORM_FULL
            specs.append(("layers.q_norm", (L, self.q_size if full else self.head_dim)))
            specs.append(("layers.k_norm", (L, self.kv_size if full else self.head_dim)))
        if not c.tie_word_embeddings:
            specs.append(("lm_head.w", (H, c.vocab_size)))
            if self.LM_HEAD_BIAS:
                specs.append(("lm_head.b", (c.vocab_size,)))
        return sorted(specs)

    def _norm_specs(self, path: str, *shape: int) -> List[Tuple[str, Tuple[int, ...]]]:
        """A norm's leaves: its weight, or with NORM_BIAS ``.w`` and ``.b``."""
        if self.NORM_BIAS:
            return [(path + ".b", shape), (path + ".w", shape)]
        return [(path, shape)]

    def norm_leaf(self, name: str, layer=None):
        """The ``norm_fn`` parameter of norm ``name`` (of ``layer``, for a
        stacked norm): its weight, or with NORM_BIAS {"w", "b"}."""
        w = getattr(self, name)
        if layer is not None:
            w = w[layer]
        if not self.NORM_BIAS:
            return w
        b = getattr(self, name + "_b")
        return {"w": w, "b": b if layer is None else b[layer]}

    def _mlp_specs(self) -> List[Tuple[str, Tuple[int, ...]]]:
        """The MLP's leaves (the MoE classes override it)."""
        c = self.config
        L, H, I = c.num_hidden_layers, c.hidden_size, c.intermediate_size
        return [("layers.down.w", (L, I, H)), ("layers.gate_up.w", (L, H, 2 * I))]

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
        logits = lm_head_logits(last_h, self.head(), self.config.logit_softcap,
                                self.lm_head_b if self.LM_HEAD_BIAS else None)
        if self.logits_div is not None:
            logits = logits / self.logits_div
        if self.logit_bias is not None:
            logits = logits + self.logit_bias
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
        h = self.embed[fb.input_ids.long()]
        if self.embed_scale is not None:
            h = h * self.embed_scale
        if self.POS_EMBED:
            h = h + self.pos_embed[fb.q_pos.long()]
        h = splice_embeds(h, fb)
        for layer in range(self.config.num_hidden_layers):
            h = self._layer(layer, h, fb, kv_cache, attention)
        return self.norm_fn(h, self.norm_leaf("final_norm"), self.config.rms_norm_eps)

    def _layer(self, layer: int, h: torch.Tensor, fb, kv_cache, attention) -> torch.Tensor:
        """One decoder layer: attention and the MLP, each on its normed
        input, each branch times ``residual_mult`` (when set) before its
        residual add; with PARALLEL_BLOCK both on the one input norm, h +
        attn + mlp."""
        eps = self.config.rms_norm_eps
        attn_in = self.norm_fn(h, self.norm_leaf("input_norm", layer), eps)
        attn = self._attn(layer, attn_in, fb, kv_cache, attention)
        if self.PARALLEL_BLOCK:
            return h + attn + self._mlp(layer, attn_in)
        if self.residual_mult is not None:
            attn = attn * self.residual_mult
        h = h + attn
        mlp = self._mlp(layer, self.norm_fn(h, self.norm_leaf("post_norm", layer), eps))
        if self.residual_mult is not None:
            mlp = mlp * self.residual_mult
        return h + mlp

    def _mlp(self, layer: int, x: torch.Tensor) -> torch.Tensor:
        """The gated MLP of ``layer`` (the MoE classes route to experts)."""
        return apply_linear(self.act(apply_linear(x, self.gate_up[layer])), self.down[layer])

    def head(self) -> torch.Tensor:
        """The lm_head [H, V] (the embedding's transpose when tied)."""
        return self.lm_head if self.lm_head is not None else self.embed.t()

    def _attn(self, layer, attn_in, fb, kv_cache, attention):
        c = self.config
        T = attn_in.shape[0]
        bias = self.qkv_bias[layer] if c.attention_bias else None
        qkv = apply_linear(attn_in, self.qkv_proj[layer], bias)
        if self.qkv_clip is not None:
            qkv = qkv.clamp(-self.qkv_clip, self.qkv_clip)
        q, k, v = qkv.split([self.q_size, self.kv_size, self.kv_size], dim=-1)
        if self.QK_NORM_FULL:  # OLMoE: before the head split
            q = self.norm_fn(q, self.q_norm[layer], c.rms_norm_eps)
            k = self.norm_fn(k, self.k_norm[layer], c.rms_norm_eps)
        q = q.reshape(T, self.num_heads, self.head_dim)
        k = k.reshape(T, self.num_kv_heads, self.head_dim)
        v = v.reshape(T, self.num_kv_heads, self.head_dim)
        if self.use_qk_norm and not self.QK_NORM_FULL:  # Qwen3: per head
            q = self.norm_fn(q, self.q_norm[layer], c.rms_norm_eps)
            k = self.norm_fn(k, self.k_norm[layer], c.rms_norm_eps)
        if not self.no_rope:
            pos = fb.mrope_pos if self.uses_mrope and fb.mrope_pos is not None else fb.q_pos
            q, k = self.rope(pos, q, k)
        out = paged_attention(
            q, k, v, kv_cache, layer, fb, page_size=self.page_size,
            scale=self.scale, logit_cap=c.attn_logit_softcap,
            sliding_window=self.layer_windows[layer], attention=attention,
            alibi_slopes=self.alibi_slopes,
        )
        return apply_linear(out.reshape(T, self.q_size), self.o_proj[layer],
                            self.o_proj_b[layer] if c.o_proj_bias else None)
