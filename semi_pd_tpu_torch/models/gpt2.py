"""GPT-2 and GPT-BigCode (port of semi_pd_tpu/models/gpt2.py): the pre-LN
block of models/llama.py with LayerNorm and its bias everywhere, learned
absolute positions (``pos_embed.w`` [n_positions, H], added to the
embedding; no rope), biases on qkv and the output projection, the
non-gated GELU MLP (models/layernorm_families.py NonGatedMLPMixin) and tied
embeddings. GPT-BigCode (StarCoder) adds multi-query attention, one KV head
for every query head (``ModelConfig.from_hf_config`` sets it from
``multi_query``), and takes its MLP's GELU from ``activation_function``.

The positions end at ``max_position_embeddings`` (GPT-2's ``n_positions``),
so the runner refuses a longer context. ``LINEAR_TF`` names the
checkpoints' linear layout (GPT-2's Conv1D [din, dout], GPT-BigCode's
[dout, din]) for loading, which waits for ROADMAP A13.
"""

from __future__ import annotations

from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.models.layernorm_families import NonGatedMLPMixin
from semi_pd_tpu_torch.models.llama import LlamaForCausalLM
from semi_pd_tpu_torch.ops.elementwise import PLAIN_ACT, layer_norm


class GPT2LMHeadModel(NonGatedMLPMixin, LlamaForCausalLM):
    PFX = "transformer."
    LINEAR_TF = "none"  # Conv1D storage
    NORM_BIAS = True
    POS_EMBED = True

    def __init__(self, config: ModelConfig, device):
        config.attention_bias = config.o_proj_bias = config.tie_word_embeddings = True
        super().__init__(config, device)
        self.norm_fn = layer_norm
        self.no_rope = True


class GPTBigCodeForCausalLM(GPT2LMHeadModel):
    LINEAR_TF = "t"

    def __init__(self, config: ModelConfig, device):
        super().__init__(config, device)
        act = config.activation_function or "gelu_pytorch_tanh"
        if act not in ("gelu_new", "gelu_pytorch_tanh"):
            self.mlp_act = PLAIN_ACT["gelu"]
