"""Model configuration (trimmed copy of semi_pd_tpu/config/model_config.py).

Holds the ModelConfig fields a Llama-family dense decoder, a
DeepSeek-V2/V3 (MLA + MoE) model, MiniCPM3 (MLA, dense, with its three
scalings) and Gemma-2 (its per-layer windows, softcaps and query scalar)
use. HF-config parsing (``from_hf_config``
/ ``from_model_path``) and the multimodal fields are not part of the port
yet (ROADMAP A13-A14): configs are built directly, as ``bench.py`` and
``__graft_entry__.py`` do; an MLA config sets ``use_mla`` and
``head_dim = qk_nope_head_dim + qk_rope_head_dim`` itself, as
``from_hf_config`` would.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional


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

    dtype: str = "bfloat16"

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
