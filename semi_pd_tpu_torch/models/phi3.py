"""Phi-3 (port of semi_pd_tpu/models/phi3.py): Llama's computation and
parameter tree (its checkpoint's fused qkv_proj and gate_up_proj are
ROADMAP A13), with the config's sliding window on every layer
(Phi-3-medium-4k's 2047) and longrope scaling where the config has it
(ops/rope.py)."""

from __future__ import annotations

from semi_pd_tpu_torch.models.llama import LlamaForCausalLM


class Phi3ForCausalLM(LlamaForCausalLM):
    pass
