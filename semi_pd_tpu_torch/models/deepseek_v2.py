"""DeepSeek-V2/V3: Multi-head Latent Attention + fine-grained MoE (port of
semi_pd_tpu/models/deepseek_v2.py::DeepseekV2ForCausalLM).

Absorb-only MLA, as in the JAX package: queries are projected into the
latent space (q_nope . W_UK, a float32 einsum cast back), the pool stores
one [c_kv | k_pe] latent row per token (mem/pool.py's latent layout), V is
the latent prefix of K, and W_UV is applied after attention. Prefill and
decode run the same path through ``layers.attention.paged_attention_mla``
(the latent pool's CUDA kernels on the card). The rope over the decoupled
q_pe / k_pe dims is GPT-J interleaved (``rope_neox``: NeoX halves, as
MiniCPM3's), with DeepSeek-yarn frequencies, and the softmax scale gets the
yarn mscale^2 correction. Three scalings are off (None) for DeepSeek and
set by MiniCPM3's wrapper (models/minicpm3.py), at the JAX sites
(deepseek_v2.py:248-259, 307-308, 337-338): the embedding times
``embed_scale``, each residual branch times ``residual_mult``, the logits
divided by ``logits_div``.

Layers are heterogeneous (``first_k_dense_replace`` dense layers, then MoE
layers with shared experts), so parameters are per layer: leaf for leaf the
JAX package's tree ``{"embed", "final_norm", "layers": [{...} per layer],
"lm_head"}`` (models/params.py gives ``init_params``, ``load_jax_params``
and ``params_tree``). Linear weights are [din, dout]. Routing is softmax
greedy (V2), grouped (V2 group_limited_greedy) or sigmoid grouped with a
score-correction bias (V3); the experts run through ops/moe.py.

Not ported: checkpoint loading and the kv_b_proj -> (W_UK, W_UV) split of
``postprocess_weight`` (ROADMAP A13), tensor parallelism (A15).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.layers.attention import paged_attention_mla
from semi_pd_tpu_torch.layers.linear import apply_linear, lm_head_logits
from semi_pd_tpu_torch.models.llama import DTYPES, dtype_scalar
from semi_pd_tpu_torch.models.params import TreeParams
from semi_pd_tpu_torch.ops.elementwise import rms_norm, silu_and_mul
from semi_pd_tpu_torch.ops.moe import moe_ffn, route_topk
from semi_pd_tpu_torch.ops.rope import RotaryEmbedding, yarn_mscale


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) in the order jax.tree visits the tree: dict keys
    sorted, list items in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _flatten(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


class DeepseekV2ForCausalLM(TreeParams):
    def __init__(self, config: ModelConfig, device, *, embed_scale=None, residual_mult=None,
                 logits_div=None, rope_neox: bool = False):
        super().__init__()
        c = self.config = config
        if not c.use_mla:
            raise ValueError("DeepseekV2ForCausalLM needs an MLA config (use_mla)")
        if c.dtype not in DTYPES:
            raise ValueError(f"model dtype {c.dtype!r}: bfloat16 or float32")
        self.dtype = DTYPES[c.dtype]
        self.num_heads = c.num_attention_heads
        self.dn, self.dr, self.dv = c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim
        self.kv_lora, self.q_lora = c.kv_lora_rank, c.q_lora_rank
        self.is_v3 = c.architecture == "DeepseekV3ForCausalLM"
        self.page_size = 16  # set by the runner: a property of the pool
        # softmax scale with the deepseek-yarn mscale^2 correction
        self.scale = (self.dn + self.dr) ** -0.5
        rs = c.rope_scaling or {}
        if rs.get("mscale_all_dim"):
            m = yarn_mscale(rs.get("factor", 1.0), rs["mscale_all_dim"])
            self.scale = self.scale * m * m
        self.rope = RotaryEmbedding(
            head_dim=self.dr, rotary_dim=self.dr, max_position=c.context_length,
            theta=c.rope_theta, rope_scaling=c.rope_scaling, is_neox_style=rope_neox,
        ).to(device)
        # the scalings, each rounded to the dtype it multiplies (None: off)
        self.embed_scale = None if embed_scale is None else dtype_scalar(embed_scale, self.dtype)
        self.residual_mult = (None if residual_mult is None
                              else dtype_scalar(residual_mult, self.dtype))
        self.logits_div = (None if logits_div is None
                           else dtype_scalar(logits_div, torch.float32))
        # each leaf is the parameter "<path with . -> __>"; per-layer views
        # self.lp[l]["kv_a.w"] for the forward pass
        self.lp: List[Dict[str, torch.nn.Parameter]] = [{} for _ in range(c.num_hidden_layers)]
        for path, shape in self.param_specs():  # quantized leaves: QuantWeight
            dtype = torch.float32 if path.endswith("e_bias") else self.dtype
            p = self.new_leaf(path, shape, dtype, device)
            setattr(self, path.replace(".", "__"), p)
            if path.startswith("layers."):
                _, l, rest = path.split(".", 2)
                self.lp[int(l)][rest] = p

    # ------------------------------------------------------------- params
    def is_moe_layer(self, l: int) -> bool:
        c = self.config
        return (c.num_experts is not None and l >= c.first_k_dense_replace
                and l % c.moe_layer_freq == 0)

    def layer_spec(self, l: int) -> Dict[str, Any]:
        """Layer ``l``'s subtree of leaf shapes (the JAX tree's
        ``layers[l]``; NextN's draft layer mirrors the last one's)."""
        c = self.config
        H, Hq = c.hidden_size, c.num_attention_heads
        lp: Dict[str, Any] = {
            "input_norm": (H,),
            "kv_a": {"w": (H, self.kv_lora + self.dr)},
            "kv_norm": (self.kv_lora,),
            "w_uk": (Hq, self.dn, self.kv_lora),
            "w_uv": (Hq, self.kv_lora, self.dv),
            "o_proj": {"w": (Hq * self.dv, H)},
            "post_norm": (H,),
        }
        if self.q_lora:
            lp["q_a"] = {"w": (H, self.q_lora)}
            lp["q_norm"] = (self.q_lora,)
            lp["q_b"] = {"w": (self.q_lora, Hq * (self.dn + self.dr))}
        else:
            lp["q_proj"] = {"w": (H, Hq * (self.dn + self.dr))}
        if self.is_moe_layer(l):
            E, F = c.num_experts, c.moe_intermediate_size
            lp["router"] = {"w": (H, E)}
            if self.is_v3:
                lp["e_bias"] = (E,)
            lp["experts"] = {"gate_up": (E, H, 2 * F), "down": (E, F, H)}
            if c.num_shared_experts:
                FS = c.num_shared_experts * F
                lp["shared"] = {"gate_up": {"w": (H, 2 * FS)}, "down": {"w": (FS, H)}}
        else:
            I = c.intermediate_size
            lp["gate_up"] = {"w": (H, 2 * I)}
            lp["down"] = {"w": (I, H)}
        return lp

    def param_specs(self) -> List[Tuple[str, Tuple[int, ...]]]:
        """(JAX tree path, shape) of every leaf, in jax.tree order."""
        c = self.config
        H = c.hidden_size
        layers = [self.layer_spec(l) for l in range(c.num_hidden_layers)]
        tree: Dict[str, Any] = {"embed": {"w": (c.vocab_size, H)}, "layers": layers,
                                "final_norm": (H,)}
        if not c.tie_word_embeddings:
            tree["lm_head"] = {"w": (H, c.vocab_size)}
        return _flatten(tree)

    def leaf(self, path: str) -> torch.nn.Parameter:
        """The parameter of JAX tree path ``path`` (e.g. "layers.3.kv_a.w")."""
        return getattr(self, path.replace(".", "__"))

    # ------------------------------------------------------------- forward
    def forward(self, fb, kv_cache: torch.Tensor, attention=None, return_hidden: bool = False,
                all_logits: bool = False):
        """One step over the flat batch ``fb``; writes this step's latent
        rows into ``kv_cache`` (the latent pool [L, 1, S, 1, Dlat]) and
        returns float32 logits [B, V] of the rows ``fb.logits_idx`` picks
        (each request's last token; every row of a speculative verify
        batch), or with ``all_logits`` of every flat token row [T, V].
        ``attention`` runs over the pool after each layer's write (default:
        the latent pool's routing to the kernels).
        ``return_hidden``: also return those rows' hidden states [B, H]
        AFTER the final norm, (logits, hidden), the state that seeds the
        NextN draft (JAX ``return_hidden``'s ``last_h``; NextN normalises it
        again with its ``hnorm``)."""
        c = self.config
        h = self.embed__w[fb.input_ids.long()]
        if self.embed_scale is not None:
            h = h * self.embed_scale
        for l in range(c.num_hidden_layers):
            h = self._layer(self.lp[l], l, h, fb, kv_cache, attention)
        h = rms_norm(h, self.final_norm, c.rms_norm_eps)
        last_h = h if all_logits else h[fb.logits_idx.long()]
        logits = lm_head_logits(last_h, self.head(), c.logit_softcap)
        if self.logits_div is not None:
            logits = logits / self.logits_div
        return (logits, last_h) if return_hidden else logits

    @property
    def embed(self) -> torch.nn.Parameter:
        """The token embedding [V, H] (shared with the NextN draft)."""
        return self.embed__w

    def head(self) -> torch.Tensor:
        """The lm_head [H, V] (the embedding's transpose when tied)."""
        return self.embed__w.t() if self.config.tie_word_embeddings else self.lm_head__w

    def _layer(self, lp, l, h, fb, kv_cache, attention):
        """One decoder layer with the leaves ``lp`` ({"kv_a.w": ...}, the
        JAX ``_ds_layer(lp, l, ...)``) over pool layer ``l``: the target's
        layer l, or NextN's draft layer at layer 0 of its one-layer pool.
        MoE or dense is read from the leaves, as JAX reads it."""
        c = self.config
        T, Hq = h.shape[0], self.num_heads
        eps = c.rms_norm_eps
        x = rms_norm(h, lp["input_norm"], eps)

        # q path
        if self.q_lora:
            q = apply_linear(rms_norm(apply_linear(x, lp["q_a.w"]), lp["q_norm"], eps),
                             lp["q_b.w"])
        else:
            q = apply_linear(x, lp["q_proj.w"])
        q = q.reshape(T, Hq, self.dn + self.dr)
        q_nope, q_pe = q[..., : self.dn], q[..., self.dn :]

        # latent kv path
        kv_a = apply_linear(x, lp["kv_a.w"])  # [T, kv_lora + dr]
        c_kv = rms_norm(kv_a[..., : self.kv_lora], lp["kv_norm"], eps)
        k_pe = kv_a[..., self.kv_lora :].reshape(T, 1, self.dr)
        q_pe, k_pe = self.rope(fb.q_pos, q_pe, k_pe)

        # absorb q into the latent space, attend, un-absorb with W_UV
        q_eff = torch.einsum("thd,hdk->thk", q_nope.float(),
                             lp["w_uk"].float()).to(q.dtype)  # [T, Hq, kv_lora]
        q_cat = torch.cat([q_eff, q_pe], dim=-1)
        latent = torch.cat([c_kv, k_pe[:, 0, :]], dim=-1)  # [T, kv_lora + dr]
        attn_lat = paged_attention_mla(q_cat, latent, kv_cache, l, fb,
                                       page_size=self.page_size, scale=self.scale,
                                       v_dim=self.kv_lora, attention=attention)
        attn = torch.einsum("thk,hkv->thv", attn_lat.float(),
                            lp["w_uv"].float()).to(h.dtype)  # [T, Hq, dv]
        attn_out = apply_linear(attn.reshape(T, Hq * self.dv), lp["o_proj.w"])
        if self.residual_mult is not None:
            attn_out = attn_out * self.residual_mult
        h = h + attn_out

        # MLP / MoE
        y = rms_norm(h, lp["post_norm"], eps)
        if "experts.gate_up" in lp:
            # V2 "greedy" ignores groups; V2's group_limited_greedy and V3
            # select within groups
            grouped = self.is_v3 or c.topk_method == "group_limited_greedy"
            weights, idx = route_topk(
                apply_linear(y, lp["router.w"]).float(), c.num_experts_per_tok,
                scoring="sigmoid" if self.is_v3 else "softmax",
                norm_topk_prob=c.norm_topk_prob,
                n_group=c.n_group if grouped else None,
                topk_group=c.topk_group if grouped else None,
                routed_scaling_factor=c.routed_scaling_factor,
                e_score_bias=lp.get("e_bias"),
                group_score_func="top2" if self.is_v3 else "max",
            )
            mlp = moe_ffn(y, lp["experts.gate_up"], lp["experts.down"], weights, idx)
            if "shared.gate_up.w" in lp:
                mlp = mlp + apply_linear(silu_and_mul(apply_linear(y, lp["shared.gate_up.w"])),
                                         lp["shared.down.w"])
        else:
            mlp = apply_linear(silu_and_mul(apply_linear(y, lp["gate_up.w"])), lp["down.w"])
        if self.residual_mult is not None:
            mlp = mlp * self.residual_mult
        return h + mlp
