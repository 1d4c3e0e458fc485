"""DeepSeek NextN / MTP speculative draft head (port of
semi_pd_tpu/speculative/nextn.py).

The multi-token-prediction module of DeepSeek (reference
srt/models/deepseek_nextn.py): token embedding and lm_head are SHARED with
the target; the draft is enorm / hnorm -> eh_proj([norm(embed);
norm(hidden)]) -> one full DeepseekV2 decoder layer (MLA attention and, as
the target's last layer, MoE or dense, run by the target's own layer code,
so on MiniCPM3 with its dense SiLU MLP, its residual scaling and its NeoX
longrope) -> shared_head.norm. It plugs into the same
EAGLE rounds as the llama draft (speculative/eagle.py ``eagle_round`` /
``eagle_tree_round``): chain or top-k tree drafting. Its draft pool is the
target's latent layout with one layer, ``[1, 1, S, 1, Dlat]``, sharing the
target's slot space and page table (the runner's ``_init_eagle``), so a
chain draft or refresh step (decode-shaped) takes the latent decode of the
pool's width (``rpa_decode_mla``; ``rpa_decode_mla_288`` on MiniCPM3) and
a tree draft step (decode-shaped, with the tree's ``spec_anc``) its
extend (``rpa_extend_mla``, ``rpa_extend_mla_288``) with the tree's
masks. Its step holds to what a round graph's capture needs: no host sync
(the MoE layer's bf16 ``torch._grouped_mm`` counts rows on the device,
float32 on the card takes the dense grouped product; only the CPU's loop,
``grouped_matmul_plain``, reads the group sizes on the host) and no shape
that depends on data.

Not ported: ``hf_weight_plan`` (NextN checkpoints wait for checkpoint
loading, ROADMAP A13; the runner refuses a draft checkpoint).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from semi_pd_tpu_torch.layers.linear import apply_linear
from semi_pd_tpu_torch.models.deepseek_v2 import DeepseekV2ForCausalLM, _flatten
from semi_pd_tpu_torch.models.params import TreeParams
from semi_pd_tpu_torch.ops.elementwise import rms_norm
from semi_pd_tpu_torch.runtime.forward_batch import AttnMeta, ForwardArrays


class NextNDraftModel(TreeParams):
    """One DeepseekV2 decoder layer behind the eh_proj merge, with the
    EagleDraftModel interface (``step`` / ``pre_head``) the rounds take. Its
    leaves are the JAX draft's parameter tree, in jax.tree order
    (``eh_proj.w``, ``enorm``, ``head_norm``, ``hnorm``, then ``layer.*``
    as the target's last layer); ``init_params(seed)`` draws the JAX
    numbers (the runners seed it with the server seed + 1)."""

    def __init__(self, target: DeepseekV2ForCausalLM, device):
        super().__init__()
        # the target lends its layer code, rope and scale; kept out of the
        # module tree so that its parameters are not the draft's
        self.__dict__["target"] = target
        c = self.config = target.config
        self.dtype = target.dtype
        self.page_size = target.page_size
        H = c.hidden_size
        tree: Dict[str, Any] = {"eh_proj": {"w": (2 * H, H)}, "enorm": (H,), "head_norm": (H,),
                                "hnorm": (H,),
                                "layer": target.layer_spec(c.num_hidden_layers - 1)}
        self._specs = _flatten(tree)
        # the decoder layer's leaves as the target's _layer reads them
        self.lp: Dict[str, torch.nn.Parameter] = {}
        for path, shape in self._specs:
            dtype = torch.float32 if path.endswith("e_bias") else self.dtype
            p = torch.nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                                   requires_grad=False)
            self.register_parameter(path.replace(".", "__"), p)
            if path.startswith("layer."):
                self.lp[path.split(".", 1)[1]] = p

    def param_specs(self):
        """(JAX tree path, shape) of every leaf, in jax.tree order."""
        return self._specs

    def leaf(self, path: str) -> torch.nn.Parameter:
        return getattr(self, path.replace(".", "__"))

    def step(
        self,
        tok_embed: torch.Tensor,  # [B, H] shared target embedding of the token
        hidden_feed: torch.Tensor,  # [B, H] previous hidden (target or draft)
        draft_kv: torch.Tensor,  # the latent draft pool [1, 1, S, 1, Dlat], updated in place
        positions: torch.Tensor,  # [B] ROPE position being written
        out_slots: torch.Tensor,  # [B] slot of this position
        page_table: torch.Tensor,
        kv_lens: torch.Tensor,  # [B] = mask position + 1
        attn_meta: AttnMeta,
        mask_positions: Optional[torch.Tensor] = None,  # [B] slot-order positions
        win_base: Optional[torch.Tensor] = None,  # [B] tree window start
        spec_anc: Optional[tuple] = None,  # the tree's ancestor masks
        attention=None,  # routing over the draft pool (default: its kernels)
    ) -> torch.Tensor:
        """One draft step: eh_proj([rms(embed; enorm); rms(hidden; hnorm)]),
        then the DeepSeek layer over layer 0 of the draft pool. Returns the
        hidden state [B, H]."""
        c = self.config
        B = tok_embed.shape[0]
        eps = c.rms_norm_eps
        x = torch.cat([rms_norm(tok_embed, self.enorm, eps),
                       rms_norm(hidden_feed.to(tok_embed.dtype), self.hnorm, eps)], dim=-1)
        h = apply_linear(x, self.eh_proj__w)
        i32 = dict(dtype=torch.int32, device=tok_embed.device)
        fb_like = ForwardArrays(
            input_ids=torch.zeros(B, **i32), q_req_idx=torch.arange(B, **i32),
            q_pos=positions, out_slots=out_slots, page_table=page_table, kv_lens=kv_lens,
            logits_idx=torch.arange(B, **i32), sampling=None, num_reqs=B,
            attn_meta=attn_meta, mask_pos=mask_positions, win_base=win_base,
            spec_anc=spec_anc,
        )
        return self.target._layer(self.lp, 0, h, fb_like, draft_kv, attention)

    def pre_head(self, h: torch.Tensor) -> torch.Tensor:
        """shared_head.norm before the (shared) lm_head."""
        return rms_norm(h, self.head_norm, self.config.rms_norm_eps)
