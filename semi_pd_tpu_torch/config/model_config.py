"""Model configuration (trimmed copy of semi_pd_tpu/config/model_config.py).

Holds the ModelConfig fields a Llama-family dense decoder uses. HF-config
parsing (``from_hf_config`` / ``from_model_path``) and the MoE / MLA /
multimodal fields are not part of this slice of the port (ROADMAP A12-A14):
configs are built directly, as ``bench.py`` and ``__graft_entry__.py`` do.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


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

    # Positional encoding
    max_position_embeddings: int = 4096
    rope_theta: float = 10000.0
    rope_scaling: Optional[Dict[str, Any]] = None
    partial_rotary_factor: float = 1.0

    # Context
    context_length: int = 4096

    dtype: str = "bfloat16"

    @property
    def kv_head_dim(self) -> int:
        """Per-token per-head KV width as stored in the pool."""
        return self.head_dim

    @property
    def num_kv_heads_total(self) -> int:
        return self.num_key_value_heads
