"""Model configuration (trimmed copy of semi_pd_tpu/config/model_config.py).

Holds the ModelConfig fields the port's families use: the Llama-family
dense decoders (Llama, Mistral, Xverse, Qwen2 with its qkv bias, Qwen3
with its per-head q/k norms), Gemma-1 and Gemma-2 (per-layer windows,
softcaps and the query scalar), the GQA MoE families (Mixtral, Qwen2-MoE,
Qwen3-MoE, OLMoE), DeepSeek-V2/V3 (MLA + MoE), MiniCPM3 (MLA, dense, with
its three scalings) and the Llama-computation variants of the JAX
package's models/llama_variants.py, glm.py, phi3.py, granite.py and
grok.py (InternLM2 and its reward model, ExaOne, Baichuan, QWen v1,
MiniCPM, XverseMoe, DeepSeek-V1, Glm, Glm4, ChatGLM, Phi-3, Granite,
Grok-1), and the LayerNorm families of layernorm_families.py, gpt2.py and
olmo_falcon_dbrx.py (StableLM, Starcoder2, Phi, Cohere, OLMo-2,
Phi-3-small, GPT-2, GPT-BigCode, OLMo-1, Falcon, DBRX), the sequence
classifiers of classify.py and the vision-language models of llava.py and
qwen2_vl.py (``is_multimodal``, with the whole HF config kept in
``hf_config`` for their vision towers). ``from_hf_config`` reads a
HuggingFace ``config.json`` (a dict, or any object with its keys as
attributes) for these architectures by the JAX package's rules;
``from_model_path`` is not part of the port (ROADMAP A13). Configs
may also be built directly, as ``bench.py`` and ``__graft_entry__.py`` do;
an MLA config then sets ``use_mla`` and ``head_dim = qk_nope_head_dim +
qk_rope_head_dim`` itself, as ``from_hf_config`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

# Architectures whose attention is Multi-head Latent Attention (the latent
# pool), as in the JAX package
MLA_ARCHS = {"DeepseekV2ForCausalLM", "DeepseekV3ForCausalLM", "MiniCPM3ForCausalLM"}
# the vision-language models (models/llava.py, models/qwen2_vl.py)
MULTIMODAL_ARCHS = ("LlavaForConditionalGeneration", "LlavaLlamaForCausalLM", "YiVLForCausalLM",
                    "LlavaVidForCausalLM", "Qwen2VLForConditionalGeneration",
                    "Qwen2_5_VLForConditionalGeneration")
# ChatGLM's three strings (the JAX clause's)
CHATGLM_ARCHS = ("ChatGLMModel", "ChatGLMForConditionalGeneration", "ChatGLMForCausalLM")
# the HF keys a class reads when it is built, kept as fields of their own
# name (ModelConfig above), by architecture
BUILD_KEYS = {
    "BaichuanForCausalLM": ("position_embedding",),
    "BaiChuanForCausalLM": ("position_embedding",),
    **{a: ("add_qkv_bias", "add_bias_linear") for a in CHATGLM_ARCHS},
    "GraniteForCausalLM": ("embedding_multiplier", "attention_multiplier",
                           "residual_multiplier", "logits_scaling"),
    **{a: ("attn_logit_softcapping", "router_logit_softcapping",
           "embedding_multiplier_scale", "output_multiplier_scale")
       for a in ("Grok1ForCausalLM", "Grok1ModelForCausalLM")},
    # the LayerNorm families (the JAX package's layernorm_families.py,
    # gpt2.py, olmo_falcon_dbrx.py)
    "StableLmForCausalLM": ("use_qkv_bias",),
    "StableLmEpochForCausalLM": ("use_qkv_bias",),
    "Starcoder2ForCausalLM": ("use_bias",),
    "CohereForCausalLM": ("logit_scale",),
    "Phi3SmallForCausalLM": ("mup_use_scaling", "mup_attn_multiplier",
                             "mup_embedding_multiplier", "mup_width_multiplier",
                             "gegelu_limit", "dummy_token_indices"),
    "GPTBigCodeForCausalLM": ("activation_function",),
    "OlmoForCausalLM": ("clip_qkv",),
    **{a: ("parallel_attn", "bias", "new_decoder_architecture", "alibi")
       for a in ("FalconForCausalLM", "RWForCausalLM")},
}
# What a HuggingFace config class resolves and a config.json dict does not
# (the JAX package reads these families through transformers' classes):
# other names of a key (the class's attribute_map, or a key its __init__
# takes for another, as FalconConfig's n_embed), by architecture
HF_ALIASES = {
    **{a: {"n_embd": "hidden_size", "n_head": "num_attention_heads",
           "n_layer": "num_hidden_layers", "n_positions": "max_position_embeddings"}
       for a in ("GPT2LMHeadModel", "GPTBigCodeForCausalLM")},
    **{a: {"n_embed": "hidden_size"} for a in ("FalconForCausalLM", "RWForCausalLM")},
    "DbrxForCausalLM": {"d_model": "hidden_size", "n_heads": "num_attention_heads",
                        "n_layers": "num_hidden_layers", "max_seq_len": "max_position_embeddings"},
}
# and the class's defaults of the keys read here, where they differ from this
# module's own fallbacks (transformers' StableLmConfig, Starcoder2Config,
# PhiConfig, CohereConfig, Olmo2Config, GPT2Config, GPTBigCodeConfig,
# OlmoConfig, FalconConfig, DbrxConfig)
_STABLELM = dict(vocab_size=50304, hidden_size=2560, intermediate_size=6912,
                 layer_norm_eps=1e-5, partial_rotary_factor=0.25, use_qkv_bias=False)
_GPT2 = dict(vocab_size=50257, hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
             layer_norm_epsilon=1e-5, tie_word_embeddings=True, max_position_embeddings=1024)
_FALCON = dict(vocab_size=65024, hidden_size=4544, num_attention_heads=71,
               layer_norm_epsilon=1e-5, tie_word_embeddings=True, max_position_embeddings=2048,
               multi_query=True, parallel_attn=True, bias=False,
               new_decoder_architecture=False, alibi=False)
HF_DEFAULTS = {
    "StableLmForCausalLM": _STABLELM,
    "StableLmEpochForCausalLM": _STABLELM,
    "Starcoder2ForCausalLM": dict(vocab_size=49152, hidden_size=3072, intermediate_size=12288,
                                  num_hidden_layers=30, num_attention_heads=24,
                                  num_key_value_heads=2, norm_epsilon=1e-5,
                                  hidden_act="gelu_pytorch_tanh", tie_word_embeddings=True,
                                  use_bias=True),
    "PhiForCausalLM": dict(vocab_size=51200, hidden_size=2048, intermediate_size=8192,
                           num_hidden_layers=24, layer_norm_eps=1e-5, hidden_act="gelu_new",
                           max_position_embeddings=2048, partial_rotary_factor=0.5),
    "CohereForCausalLM": dict(vocab_size=256000, hidden_size=8192, intermediate_size=22528,
                              num_hidden_layers=40, num_attention_heads=64,
                              layer_norm_eps=1e-5, tie_word_embeddings=True,
                              max_position_embeddings=8192, logit_scale=0.0625),
    "Olmo2ForCausalLM": dict(vocab_size=50304, intermediate_size=11008, rms_norm_eps=1e-5,
                             max_position_embeddings=2048),
    "GPT2LMHeadModel": dict(_GPT2, activation_function="gelu_new"),
    "GPTBigCodeForCausalLM": dict(_GPT2, multi_query=True,
                                  activation_function="gelu_pytorch_tanh"),
    "OlmoForCausalLM": dict(vocab_size=50304, intermediate_size=11008,
                            max_position_embeddings=2048),
    "FalconForCausalLM": _FALCON,
    "RWForCausalLM": _FALCON,
    "DbrxForCausalLM": dict(hidden_size=2048, num_hidden_layers=24, num_attention_heads=16,
                            max_position_embeddings=2048),
}

def _with_architecture(cfg, arch: str):
    """A dict copy of config ``cfg`` (a dict or an object) naming ``arch``."""
    d = dict(cfg) if isinstance(cfg, dict) else (
        cfg.to_dict() if hasattr(cfg, "to_dict") else dict(vars(cfg)))
    return {**d, "architectures": [arch]}


# DBRX's nested configs' defaults (DbrxAttentionConfig, DbrxFFNConfig)
DBRX_SUB_DEFAULTS = dict(kv_n_heads=1, rope_theta=10000.0, clip_qkv=None, ffn_hidden_size=3584,
                         moe_num_experts=4, moe_top_k=1)


@dataclasses.dataclass
class ModelConfig:
    architecture: str

    # Core transformer dims
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    hidden_act: str = "silu"
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    logit_softcap: Optional[float] = None
    attn_logit_softcap: Optional[float] = None
    sliding_window: Optional[int] = None
    # per-layer "full_attention" / "sliding_attention" (HF layer_types)
    layer_types: Optional[List[str]] = None
    # Gemma-2's attention scale is query_pre_attn_scalar ** -0.5, which the
    # JAX package reads from the HF config (semi_pd_tpu/models/gemma2.py:40);
    # None: head_dim, as there
    query_pre_attn_scalar: Optional[float] = None

    # Positional encoding
    max_position_embeddings: int = 4096
    rope_theta: float = 10000.0
    rope_scaling: Optional[Dict[str, Any]] = None
    partial_rotary_factor: float = 1.0

    # Context
    context_length: int = 4096

    # MoE (None => dense)
    num_experts: Optional[int] = None
    num_experts_per_tok: int = 2
    moe_intermediate_size: Optional[int] = None
    num_shared_experts: int = 0
    moe_layer_freq: int = 1
    first_k_dense_replace: int = 0
    n_group: Optional[int] = None  # deepseek grouped routing
    topk_group: Optional[int] = None
    topk_method: Optional[str] = None  # greedy | group_limited_greedy | noaux_tc
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = False
    scoring_func: str = "softmax"  # softmax | sigmoid (deepseek v3)

    # MLA (None => standard MHA/GQA)
    use_mla: bool = False
    q_lora_rank: Optional[int] = None
    kv_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # MiniCPM3's scalings (None: not applied), which the JAX package reads
    # from the HF config (semi_pd_tpu/models/llama_variants.py:356-364):
    # the embedding times scale_emb, each residual branch times
    # scale_depth / sqrt(num_hidden_layers), logits divided by
    # hidden_size / dim_model_base
    scale_emb: Optional[float] = None
    scale_depth: Optional[float] = None
    dim_model_base: Optional[float] = None

    # What the other variant classes read from their HF config when they
    # are built (None: the key is absent, and the class takes the JAX
    # class's default): Baichuan's position_embedding ("ALIBI" or "ROPE";
    # semi_pd_tpu/models/llama_variants.py:144-148), ChatGLM's
    # add_qkv_bias / add_bias_linear (glm.py:84-87), Granite's four
    # multipliers (granite.py:16-20) and Grok-1's softcaps and multipliers
    # (grok.py:39-44)
    position_embedding: Optional[str] = None
    add_qkv_bias: Optional[bool] = None
    add_bias_linear: Optional[bool] = None
    embedding_multiplier: Optional[float] = None
    attention_multiplier: Optional[float] = None
    residual_multiplier: Optional[float] = None
    logits_scaling: Optional[float] = None
    attn_logit_softcapping: Optional[float] = None
    router_logit_softcapping: Optional[float] = None
    embedding_multiplier_scale: Optional[float] = None
    output_multiplier_scale: Optional[float] = None

    # embedding / reward models: *Model, *Classification and *Reward*
    # architecture strings, as the JAX rule sets it (the port's Engine
    # reads ServerArgs.is_embedding)
    is_embedding: bool = False

    # a bias on the attention's output projection (o_proj / dense / c_proj)
    o_proj_bias: bool = False
    # What the LayerNorm families read from their HF config when they are
    # built (BUILD_KEYS; None: the key is absent, and the class takes the
    # JAX class's default): StableLM's use_qkv_bias, Starcoder2's use_bias
    # (layernorm_families.py:70-96), Cohere's logit_scale (:146), Phi-3-small's
    # mup_* scalings, gegelu_limit and dummy_token_indices (:212-238),
    # GPT-BigCode's activation_function (gpt2.py:70), OLMo-1's clip_qkv
    # (DBRX's comes from its attn_config), Falcon's parallel_attn, bias,
    # new_decoder_architecture and alibi (olmo_falcon_dbrx.py:59-75)
    use_qkv_bias: Optional[bool] = None
    use_bias: Optional[bool] = None
    logit_scale: Optional[float] = None
    mup_use_scaling: Optional[bool] = None
    mup_attn_multiplier: Optional[float] = None
    mup_embedding_multiplier: Optional[float] = None
    mup_width_multiplier: Optional[float] = None
    gegelu_limit: Optional[float] = None
    dummy_token_indices: Optional[List[int]] = None
    activation_function: Optional[str] = None
    clip_qkv: Optional[float] = None
    parallel_attn: Optional[bool] = None
    bias: Optional[bool] = None
    new_decoder_architecture: Optional[bool] = None
    alibi: Optional[bool] = None

    dtype: str = "bfloat16"

    # the vision-language models (the JAX fields): the outer architecture of
    # a config that wraps a text_config, whose whole HF config (a dict or an
    # object) is kept for the vision tower and the image token; hf_config is
    # kept for every config (a classifier's num_labels, a Qwen-VL's flat
    # vision_config)
    is_multimodal: bool = False
    hf_config: Optional[Any] = dataclasses.field(default=None, repr=False)

    @property
    def kv_head_dim(self) -> int:
        """Per-token per-head KV width as stored in the pool: the latent
        row [c_kv | k_pe] under MLA."""
        if self.use_mla:
            return self.kv_lora_rank + self.qk_rope_head_dim
        return self.head_dim

    @property
    def num_kv_heads_total(self) -> int:
        return 1 if self.use_mla else self.num_key_value_heads

    @classmethod
    def from_hf_config(cls, hf_config, context_length: Optional[int] = None,
                       dtype: str = "bfloat16") -> "ModelConfig":
        """A ModelConfig from a HuggingFace config (a dict, or an object
        with the keys as attributes): the JAX ``from_hf_config``'s common
        part and its clauses for the served architectures
        (semi_pd_tpu/config/model_config.py:107-286), rule for rule:

        - ``architectures[0]``, or for an object without it its class name
          (FooConfig -> FooForCausalLM);
        - a ``Qwen*`` architecture that is not MoE takes a qkv bias unless
          the config sets ``attention_bias``;
        - MoE detection from ``num_local_experts`` / ``n_routed_experts`` /
          ``num_experts``; the MLA clause for DeepSeek-V2/V3 and MiniCPM3;
        - ``sliding_window`` is taken as the config gives it, also where a
          Qwen config turns it off with ``use_sliding_window: false`` (the
          JAX package reads no such switch, so Qwen1.5-MoE-A2.7B's 32768
          window applies to every layer).

        - the variants' clauses (JAX :221-258): ExaOne's ``num_layers`` and
          ``activation_function``; QWen v1's halved intermediate size,
          ``rotary_emb_base`` and ``seq_length``; ChatGLM's ``num_layers``,
          ``padded_vocab_size``, ``ffn_hidden_size``, ``kv_channels``,
          ``multi_query_group_num``, ``layernorm_epsilon``, ``seq_length``,
          rope base ``10000 * rope_ratio`` over half of head_dim;
          XverseMoe's ``moe_top_k`` and shared experts, before the MoE
          clause sets them again;
        - the LayerNorm families' clauses (JAX :182-215): one KV head for
          GPT-BigCode and Falcon under ``multi_query``, Falcon's gelu,
          DBRX's nested ``attn_config`` / ``ffn_config`` (top-k weights
          renormalized, untied, eps 1e-5), Phi-3-small's
          ``rope_embedding_base`` and linear ``rope_position_scale``; keys
          read through their HF class's aliases and defaults (HF_ALIASES,
          HF_DEFAULTS: GPT-2's ``n_embd`` / ``n_positions``, DBRX's
          ``d_model``, GPT-2's and Falcon's tied embeddings, Cohere's
          ``logit_scale``, StableLM's and Phi's partial rotary factors), as
          the JAX package reads them through transformers' config classes.
          Phi-3-small has no such class: its width is ``intermediate_size``
          or 4 x hidden, as JAX reads it (its config.json names the width
          ``ff_intermediate_size``: ROADMAP C);
        - the VLM clause (JAX :117-131): a config with a ``text_config``
          (LLaVA's, Yi-VL's, LLaVA-Vid's) is read from its text config,
          then takes the outer architecture (``LlavaForConditionalGeneration``
          for a ``LlavaConfig`` without one), ``is_multimodal`` and the
          whole config as ``hf_config``; Qwen2-VL's flat config.json is
          read as it is (``is_multimodal`` from the architecture);
        - ``is_embedding`` for the *Model, *Classification and *Reward*
          strings (ChatGLMModel and QWenLMHeadModel among them, which the
          JAX rule flags too; nothing but the Engine's ServerArgs acts on
          it).

        What the JAX models read from their HF config at build time is a
        field here: Gemma's ``query_pre_attn_scalar`` and Gemma-2's
        softcaps (``attn_logit_softcapping``, ``final_logit_softcapping``;
        a key the config leaves out is None, which Gemma2ForCausalLM
        resolves to the JAX default), MiniCPM's and MiniCPM3's
        ``scale_emb``, ``scale_depth`` and ``dim_model_base``, the keys of
        ``BUILD_KEYS`` (Baichuan, ChatGLM, Granite, Grok-1, the LayerNorm
        families), and
        Qwen2-MoE's shared expert, ``num_shared_experts =
        shared_expert_intermediate_size // moe_intermediate_size`` (at
        least 1), which the JAX ``Qwen2MoeForCausalLM.__init__`` sets.
        Other architectures raise, naming ROADMAP A14."""
        def raw(cfg, k):
            """(present, value) of key ``k`` of a dict or an object."""
            if isinstance(cfg, dict):
                return k in cfg, cfg.get(k)
            return hasattr(cfg, k), getattr(cfg, k, None)

        # the runner's table is the one list of what the port serves (imported
        # here: the runner imports this module)
        from semi_pd_tpu_torch.runtime.model_runner import ARCHITECTURES

        present, inner = raw(hf_config, "text_config")
        if inner is not None and raw(inner, "num_hidden_layers")[0]:
            # the text config, read as the JAX package reads it: its own
            # architecture if it names one, else a Llama trunk (a text
            # config class the JAX rule names after itself has no clause)
            if (raw(inner, "architectures")[1] or [None])[0] not in ARCHITECTURES:
                inner = _with_architecture(inner, "LlamaForCausalLM")
            cfg = cls.from_hf_config(inner, context_length=context_length, dtype=dtype)
            outer = raw(hf_config, "architectures")[1]
            if outer:
                cfg.architecture = outer[0]
            elif type(hf_config).__name__ == "LlavaConfig":
                cfg.architecture = "LlavaForConditionalGeneration"
            cfg.is_multimodal = True
            cfg.hf_config = hf_config
            return cfg
        present, arch_list = raw(hf_config, "architectures")
        if arch_list:
            arch = arch_list[0]
        else:
            name = type(hf_config).__name__
            arch = (name[: -len("Config")] + "ForCausalLM"
                    if name.endswith("Config") and name != "Config" else "LlamaForCausalLM")
        aliases = {v: k for k, v in HF_ALIASES.get(arch, {}).items()}
        defaults = HF_DEFAULTS.get(arch, {})

        def g(k, d=None):
            """Key ``k`` as the family's HF class reads it: the config's own
            key, else its alias (HF_ALIASES), else the class's default
            (HF_DEFAULTS), else ``d``."""
            for key in (k, aliases.get(k)):
                if key is not None:
                    present, v = raw(hf_config, key)
                    if present:
                        return v
            return defaults.get(k, d)

        if arch not in ARCHITECTURES:
            raise NotImplementedError(f"{arch}: the port reads the configs of "
                                      f"{sorted(ARCHITECTURES)}; other families are ROADMAP A14")
        num_heads = g("num_attention_heads", 32)
        hidden = g("hidden_size", 4096)
        cfg = cls(
            architecture=arch,
            vocab_size=g("vocab_size", 32000),
            hidden_size=hidden,
            intermediate_size=g("intermediate_size") or 4 * hidden,
            num_hidden_layers=g("num_hidden_layers", 32),
            num_attention_heads=num_heads,
            num_key_value_heads=g("num_key_value_heads") or num_heads,
            head_dim=g("head_dim") or hidden // num_heads,
            rms_norm_eps=(g("rms_norm_eps") or g("norm_epsilon") or g("layer_norm_eps")
                          or g("layer_norm_epsilon") or 1e-6),
            hidden_act=g("hidden_act", "silu"),
            tie_word_embeddings=g("tie_word_embeddings", False),
            attention_bias=g("attention_bias", g("qkv_bias", False)),
            sliding_window=g("sliding_window"),
            layer_types=g("layer_types"),
            max_position_embeddings=g("max_position_embeddings", 4096),
            rope_theta=g("rope_theta", 10000.0),
            rope_scaling=g("rope_scaling"),
            partial_rotary_factor=g("partial_rotary_factor", 1.0),
            dtype=dtype,
        )
        cfg.context_length = context_length or g("max_position_embeddings", 4096)
        # Qwen2 puts a bias on qkv but not on o / the MLP
        if arch.startswith("Qwen") and "Moe" not in arch:
            cfg.attention_bias = True if g("attention_bias") is None else cfg.attention_bias
        if arch == "ExaoneForCausalLM":  # its own names for depth and activation
            cfg.num_hidden_layers = g("num_layers", cfg.num_hidden_layers)
            cfg.hidden_act = g("activation_function", "silu")
        if arch == "QWenLMHeadModel":
            # QWen v1 stores the fused w1 + w2 width; its rope base and
            # length under keys of its own
            cfg.intermediate_size //= 2
            cfg.rope_theta = g("rotary_emb_base", 10000.0)
            cfg.max_position_embeddings = g("seq_length", 8192)
            cfg.context_length = context_length or cfg.max_position_embeddings
        if arch in CHATGLM_ARCHS:  # ChatGLM's own names; rope over half of head_dim
            cfg.num_hidden_layers = g("num_layers", cfg.num_hidden_layers)
            cfg.vocab_size = g("padded_vocab_size", cfg.vocab_size)
            cfg.intermediate_size = g("ffn_hidden_size", cfg.intermediate_size)
            cfg.head_dim = g("kv_channels") or cfg.head_dim
            if g("multi_query_attention", False):
                cfg.num_key_value_heads = g("multi_query_group_num", 2)
            cfg.rms_norm_eps = g("layernorm_epsilon", 1e-5)
            cfg.max_position_embeddings = g("seq_length", 8192)
            cfg.context_length = context_length or cfg.max_position_embeddings
            cfg.rope_theta = 10000.0 * g("rope_ratio", 1.0)
            cfg.partial_rotary_factor = 0.5
            cfg.tie_word_embeddings = g("tie_word_embeddings", False)
        if arch == "XverseMoeForCausalLM":
            # read before the MoE clause, which sets all but the expert width
            # again (the JAX order)
            cfg.num_experts_per_tok = g("moe_top_k", 2)
            cfg.moe_intermediate_size = cfg.intermediate_size
            cfg.num_shared_experts = g("num_shared_experts") or 0
            cfg.norm_topk_prob = g("norm_topk_prob", True)
        n_experts = g("num_local_experts") or g("n_routed_experts") or g("num_experts")
        if n_experts:
            cfg.num_experts = n_experts
            cfg.num_experts_per_tok = g("num_experts_per_tok", 2)
            cfg.moe_intermediate_size = g("moe_intermediate_size") or cfg.intermediate_size
            cfg.num_shared_experts = g("n_shared_experts") or 0
            cfg.first_k_dense_replace = g("first_k_dense_replace", 0)
            cfg.moe_layer_freq = g("moe_layer_freq", 1)
            cfg.n_group = g("n_group")
            cfg.topk_group = g("topk_group")
            cfg.topk_method = g("topk_method")
            cfg.routed_scaling_factor = g("routed_scaling_factor", 1.0)
            cfg.norm_topk_prob = g("norm_topk_prob", False)
            cfg.scoring_func = g("scoring_func", "softmax")
        if arch in MLA_ARCHS and g("kv_lora_rank"):
            cfg.use_mla = True
            cfg.q_lora_rank = g("q_lora_rank")
            cfg.kv_lora_rank = g("kv_lora_rank")
            cfg.qk_nope_head_dim = g("qk_nope_head_dim", 128)
            cfg.qk_rope_head_dim = g("qk_rope_head_dim", 64)
            cfg.v_head_dim = g("v_head_dim", 128)
            cfg.head_dim = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        if arch.endswith(("EmbeddingModel", "Model", "Classification")) or "Reward" in arch:
            cfg.is_embedding = True
        # what the JAX models read from the HF config when they are built
        for key in BUILD_KEYS.get(arch, ()):
            setattr(cfg, key, g(key))
        if arch in ("GemmaForCausalLM", "Gemma2ForCausalLM", "Gemma2ForSequenceClassification"):
            cfg.query_pre_attn_scalar = g("query_pre_attn_scalar")
        if arch in ("Gemma2ForCausalLM", "Gemma2ForSequenceClassification"):
            cfg.attn_logit_softcap = g("attn_logit_softcapping")
            cfg.logit_softcap = g("final_logit_softcapping")
        if arch in ("MiniCPMForCausalLM", "MiniCPM3ForCausalLM"):
            cfg.scale_emb = g("scale_emb")
            cfg.scale_depth = g("scale_depth")
            cfg.dim_model_base = g("dim_model_base")
        # GPT-BigCode's and Falcon's multi-query attention: one shared KV
        # head (the JAX clause names these two strings, not RWForCausalLM);
        # Falcon's MLP is gelu
        if arch in ("GPTBigCodeForCausalLM", "FalconForCausalLM") and g("multi_query", True):
            cfg.num_key_value_heads = 1
        if arch == "FalconForCausalLM":
            cfg.hidden_act = "gelu"
        if arch == "DbrxForCausalLM":  # attention and experts in nested configs
            def sub(name, k):
                present, v = raw(g(name) or {}, k)
                return v if present else DBRX_SUB_DEFAULTS[k]

            cfg.num_key_value_heads = sub("attn_config", "kv_n_heads")
            cfg.rope_theta = sub("attn_config", "rope_theta")
            cfg.clip_qkv = sub("attn_config", "clip_qkv")
            cfg.num_experts = sub("ffn_config", "moe_num_experts")
            cfg.num_experts_per_tok = sub("ffn_config", "moe_top_k")
            cfg.moe_intermediate_size = sub("ffn_config", "ffn_hidden_size")
            cfg.norm_topk_prob = True
            cfg.tie_word_embeddings = False
            cfg.rms_norm_eps = 1e-5  # nn.LayerNorm's default
        if arch == "Phi3SmallForCausalLM":
            # its rope under keys of its own; without rope_scaling, linear
            # scaling by rope_position_scale
            cfg.rope_theta = g("rope_embedding_base", 1000000.0)
            if cfg.rope_scaling is None:
                cfg.rope_scaling = {"rope_type": "linear",
                                    "factor": g("rope_position_scale", 1.0)}
        if arch == "Qwen2MoeForCausalLM" and not cfg.num_shared_experts:
            ses = g("shared_expert_intermediate_size")
            if ses:
                cfg.num_shared_experts = max(1, ses // cfg.moe_intermediate_size)
        cfg.is_multimodal = arch in MULTIMODAL_ARCHS
        cfg.hf_config = hf_config
        return cfg
