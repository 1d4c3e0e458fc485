"""Qwen2-VL and Qwen2.5-VL (port of semi_pd_tpu/models/qwen2_vl.py).

Three pieces, as in the JAX module:

- ``Qwen2VisionTower``: a ViT over flattened patches (``patchify``'s
  layout [n_patches, C * tp * ps * ps], a linear in place of the Conv3d),
  whose q and k carry a 2D rope ((h, w) positions of the patch grid in
  spatial-merge-block order, ``_grid_pos`` / ``_vrope``), LayerNorm blocks
  with quick-GELU, and a merger that folds each 2 x 2 block of patches
  into one token of the text width (LayerNorm, linear, exact GELU,
  linear);
- ``Qwen25VisionTower``: RMSNorm blocks, a SwiGLU MLP with biases, and
  window attention: the patches are permuted into window order
  (``_window_index``, HF get_window_index; windows of ``window_size``
  pixels, padded at the grid's edges) and each block attends within its
  window, but the ``fullatt_block_indexes`` blocks, over the whole image;
  the merged tokens are un-permuted at the end;
- the language model: the port's Llama with a qkv bias and M-RoPE
  (``ops/rope.py MRotaryEmbedding`` over ``mrope_section``; each token's
  (t, h, w) position from ``get_mrope_positions``, HF get_rope_index for
  images), the towers' features spliced over the image tokens.

The towers compute in the model dtype, as the JAX towers do, with plain
torch ops (matmuls, softmax; the JAX package computes them outside
Pallas, so they have no kernel). The parameter tree is the JAX model's:
Llama's leaves and ``vision.*``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.models.llama import LlamaForCausalLM
from semi_pd_tpu_torch.models.params import TreeParams
from semi_pd_tpu_torch.models.vision import cfg_get, quick_gelu
from semi_pd_tpu_torch.ops.elementwise import layer_norm, rms_norm, silu_and_mul
from semi_pd_tpu_torch.ops.rope import MRotaryEmbedding


class Qwen2VisionTower(TreeParams):
    """Qwen2-VL's ViT (HF Qwen2VisionTransformerPretrainedModel)."""

    def __init__(self, vcfg, out_hidden: int, dtype: torch.dtype, device):
        super().__init__()
        g = lambda k, d=None: cfg_get(vcfg, k, d)
        self._read(g)
        self.out_hidden = out_hidden
        self.dtype = dtype
        self.head_dim = self.embed_dim // self.num_heads
        self.patch_in = self.in_ch * self.tpatch * self.patch * self.patch
        # the 2D rope's table (theta 10000), head_dim / 4 channels an axis
        half = self.head_dim // 2
        inv = 1.0 / (10000.0 ** (np.arange(0, half, 2, dtype=np.float64) / half))
        fr = np.outer(np.arange(4096, dtype=np.float64), inv)
        self.register_buffer("vcos", torch.from_numpy(np.cos(fr).astype(np.float32)).to(device),
                             persistent=False)
        self.register_buffer("vsin", torch.from_numpy(np.sin(fr).astype(np.float32)).to(device),
                             persistent=False)
        self.make_leaves(dtype, device)

    def _read(self, g) -> None:
        self.embed_dim = g("embed_dim")
        self.depth = g("depth")
        self.num_heads = g("num_heads")
        self.mlp_dim = int(self.embed_dim * g("mlp_ratio"))
        self.in_ch = g("in_channels", g("in_chans", 3))
        self.patch = g("patch_size")
        self.tpatch = g("temporal_patch_size", 2)
        self.merge = g("spatial_merge_size", 2)

    def param_specs(self) -> List[Tuple[str, Tuple[int, ...]]]:
        E, M, L, m2 = self.embed_dim, self.mlp_dim, self.depth, self.merge ** 2
        specs = [("patch.w", (self.patch_in, E)),
                 ("merger.fc1.w", (E * m2, E * m2)), ("merger.fc1.b", (E * m2,)),
                 ("merger.fc2.w", (E * m2, self.out_hidden)), ("merger.fc2.b", (self.out_hidden,))]
        specs += self._norm_specs()
        for name, din, dout in self._linears():
            specs += [(f"blocks.{name}.w", (L, din, dout)), (f"blocks.{name}.b", (L, dout))]
        return sorted(specs)

    def _norm_specs(self):
        E, L = self.embed_dim, self.depth
        return [("merger.ln_q.w", (E,)), ("merger.ln_q.b", (E,)),
                ("blocks.ln1.w", (L, E)), ("blocks.ln1.b", (L, E)),
                ("blocks.ln2.w", (L, E)), ("blocks.ln2.b", (L, E))]

    def _linears(self):
        E, M = self.embed_dim, self.mlp_dim
        return [("qkv", E, 3 * E), ("proj", E, E), ("fc1", E, M), ("fc2", M, E)]

    # ---------------------------------------------------------------- rope
    def _grid_pos(self, t: int, h: int, w: int) -> np.ndarray:
        """Per-patch (h, w) indices in spatial-merge-block order (HF
        Qwen2VisionTransformer.rot_pos_emb), [t * h * w, 2]."""
        m = self.merge
        hp = np.arange(h).reshape(h, 1).repeat(w, 1)
        wp = np.arange(w).reshape(1, w).repeat(h, 0)
        hp = hp.reshape(h // m, m, w // m, m).transpose(0, 2, 1, 3).reshape(-1)
        wp = wp.reshape(h // m, m, w // m, m).transpose(0, 2, 1, 3).reshape(-1)
        return np.stack([np.tile(hp, t), np.tile(wp, t)], axis=1)

    def _vrope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x [L, heads, hd]; pos [L, 2]: NeoX rope with cos / sin of
        concat(freqs[h], freqs[w]) (HF apply_rotary_pos_emb_vision), in
        float32, cast back."""
        cos = torch.cat([self.vcos[pos[:, 0]], self.vcos[pos[:, 1]]], dim=-1)[:, None, :]
        sin = torch.cat([self.vsin[pos[:, 0]], self.vsin[pos[:, 1]]], dim=-1)[:, None, :]
        x1, x2 = x.float().chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)

    # ------------------------------------------------------------- forward
    def _lin(self, x: torch.Tensor, name: str, layer=None) -> torch.Tensor:
        w, b = self.leaf(name + ".w"), self.leaf(name + ".b")
        if layer is not None:
            w, b = w[layer], b[layer]
        return x @ w + b

    def _attend(self, x, layer: int, pos, mask=None) -> torch.Tensor:
        """One block's attention: [L, E] -> [L, E] (its output projection
        included); ``mask`` [L, L] bool: the pairs that may attend."""
        L = x.shape[0]
        q, k, v = self._lin(x, "blocks.qkv", layer).split(self.embed_dim, dim=-1)
        q = self._vrope(q.reshape(L, self.num_heads, self.head_dim), pos)
        k = self._vrope(k.reshape(L, self.num_heads, self.head_dim), pos)
        v = v.reshape(L, self.num_heads, self.head_dim)
        att = torch.einsum("lhd,mhd->hlm", q, k).float() * self.head_dim ** -0.5
        if mask is not None:
            att = att.masked_fill(~mask[None], float("-inf"))
        o = torch.einsum("hlm,mhd->lhd", torch.softmax(att, dim=-1).to(v.dtype), v)
        return self._lin(o.reshape(L, self.embed_dim), "blocks.proj", layer)

    def forward(self, patches: torch.Tensor, grid: Tuple[int, int, int]) -> torch.Tensor:
        """patches [L, patch_in] -> merged features [L / merge^2, out_hidden]
        in the model dtype."""
        x = patches.to(self.dtype) @ self.leaf("patch.w")
        pos = torch.as_tensor(self._grid_pos(*grid), device=x.device)
        ln = lambda y, n, l=None: layer_norm(
            y, {"w": self.leaf(n + ".w")[l], "b": self.leaf(n + ".b")[l]}
            if l is not None else {"w": self.leaf(n + ".w"), "b": self.leaf(n + ".b")}, 1e-6)
        for layer in range(self.depth):
            x = x + self._attend(ln(x, "blocks.ln1", layer), layer, pos)
            y = quick_gelu(self._lin(ln(x, "blocks.ln2", layer), "blocks.fc1", layer))
            x = x + self._lin(y, "blocks.fc2", layer)
        return self._merge(ln(x, "merger.ln_q"))

    def _merge(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(-1, self.embed_dim * self.merge ** 2)
        return self._lin(F.gelu(self._lin(x, "merger.fc1")), "merger.fc2")


class Qwen25VisionTower(Qwen2VisionTower):
    """Qwen2.5-VL's ViT (HF Qwen2_5_VisionTransformerPretrainedModel):
    RMSNorm (eps 1e-6) blocks, a SwiGLU MLP with biases, window attention
    but at ``fullatt_block_indexes``."""

    def _read(self, g) -> None:
        self.embed_dim = g("hidden_size")
        self.depth = g("depth")
        self.num_heads = g("num_heads")
        self.mlp_dim = g("intermediate_size")
        self.in_ch = g("in_channels", g("in_chans", 3))
        self.patch = g("patch_size")
        self.tpatch = g("temporal_patch_size", 2)
        self.merge = g("spatial_merge_size", 2)
        self.window_size = g("window_size", 112)
        self.fullatt = set(g("fullatt_block_indexes", []) or [])

    def _norm_specs(self):
        E, L = self.embed_dim, self.depth
        return [("merger.ln_q", (E,)), ("blocks.ln1", (L, E)), ("blocks.ln2", (L, E))]

    def _linears(self):
        E, M = self.embed_dim, self.mlp_dim
        return [("qkv", E, 3 * E), ("proj", E, E), ("gate_up", E, 2 * M), ("down", M, E)]

    def _window_index(self, t: int, h: int, w: int):
        """HF get_window_index: the merged tokens' permutation into window
        order, and each window's count of raw patches."""
        m = self.merge
        lh, lw = h // m, w // m
        ws = self.window_size // m // self.patch
        idx = np.arange(t * lh * lw).reshape(t, lh, lw)
        pad_h, pad_w = (-lh) % ws, (-lw) % ws
        padded = np.full((t, lh + pad_h, lw + pad_w), -100, np.int64)
        padded[:, :lh, :lw] = idx
        nh, nw = (lh + pad_h) // ws, (lw + pad_w) // ws
        padded = padded.reshape(t, nh, ws, nw, ws).transpose(0, 1, 3, 2, 4)
        padded = padded.reshape(t, nh * nw, ws, ws)
        seqlens = (padded != -100).sum(axis=(2, 3)).reshape(-1)
        flat = padded.reshape(-1)
        return flat[flat != -100], seqlens[seqlens > 0] * (m ** 2)

    def forward(self, patches: torch.Tensor, grid: Tuple[int, int, int]) -> torch.Tensor:
        x = patches.to(self.dtype) @ self.leaf("patch.w")
        m2 = self.merge ** 2
        window_index, counts = self._window_index(*grid)
        # raw patches (groups of merge^2) into window order
        perm = (window_index[:, None] * m2 + np.arange(m2)[None, :]).reshape(-1)
        dev = x.device
        x = x[torch.as_tensor(perm, device=dev)]
        pos = torch.as_tensor(self._grid_pos(*grid)[perm], device=dev)
        win = torch.as_tensor(np.repeat(np.arange(len(counts)), counts), device=dev)
        mask = win[:, None] == win[None, :]
        for layer in range(self.depth):
            y = rms_norm(x, self.leaf("blocks.ln1")[layer], 1e-6)
            x = x + self._attend(y, layer, pos, None if layer in self.fullatt else mask)
            y = rms_norm(x, self.leaf("blocks.ln2")[layer], 1e-6)
            y = silu_and_mul(self._lin(y, "blocks.gate_up", layer))
            x = x + self._lin(y, "blocks.down", layer)
        x = self._merge(rms_norm(x, self.leaf("merger.ln_q"), 1e-6))
        return x[torch.as_tensor(np.argsort(window_index), device=dev)]


class Qwen2VLForConditionalGeneration(LlamaForCausalLM):
    is_multimodal = True
    uses_mrope = True
    TOWER_CLS = Qwen2VisionTower

    def __init__(self, config: ModelConfig, device):
        config.attention_bias = True
        super().__init__(config, device)
        hf = config.hf_config
        self.image_token_index = cfg_get(hf, "image_token_id", 151655)
        vcfg = cfg_get(hf, "vision_config")
        out_hidden = cfg_get(vcfg, "out_hidden_size") or config.hidden_size
        self.tower = self.TOWER_CLS(vcfg, out_hidden, self.dtype, device)

    def make_rope(self) -> MRotaryEmbedding:
        """M-RoPE over ``rope_scaling["mrope_section"]`` (else the rotary
        half cut in thirds, the larger share to t), on the default table
        (the config's ``{"type": "mrope"}``, which MRotaryEmbedding takes)."""
        c = self.config
        rot = int(self.head_dim * c.partial_rotary_factor)
        sect = (c.rope_scaling or {}).get("mrope_section")
        if not sect:
            half = rot // 2
            sect = [half - 2 * (half // 3), half // 3, half // 3]
        return MRotaryEmbedding(head_dim=self.head_dim, rotary_dim=rot,
                                max_position=c.context_length, theta=c.rope_theta,
                                rope_scaling=c.rope_scaling, mrope_section=sect)

    # ------------------------------------------------------------- params
    def param_specs(self) -> List[Tuple[str, Tuple[int, ...]]]:
        specs = super().param_specs()
        if getattr(self, "tower", None) is None:  # the Llama leaves, made first
            return specs
        return sorted(specs + [("vision." + p, s) for p, s in self.tower.param_specs()])

    def leaf(self, path: str) -> torch.nn.Parameter:
        if path.startswith("vision."):
            return self.tower.leaf(path[len("vision."):])
        return super().leaf(path)

    # --------------------------------------------------------- multimodal
    def patchify(self, img: np.ndarray) -> Tuple[np.ndarray, Tuple[int, int, int]]:
        """A normalized [C, H, W] image -> HF's flattened patch layout
        [gh * gw, C * tp * ps * ps] (the image repeated over the temporal
        patch; Qwen2VLImageProcessor._preprocess) and its grid (1, gh, gw)."""
        ps, tp, m = self.tower.patch, self.tower.tpatch, self.tower.merge
        C, H, W = img.shape
        gh, gw = H // ps, W // ps
        x = np.tile(img[None], (tp, 1, 1, 1))  # [tp, C, H, W]
        x = x.reshape(tp, C, gh // m, m, ps, gw // m, m, ps)
        x = x.transpose(2, 5, 3, 6, 1, 0, 4, 7)
        return x.reshape(gh * gw, C * tp * ps * ps).astype(np.float32), (1, gh, gw)

    def encode_images(self, patches: torch.Tensor, grid) -> torch.Tensor:
        return self.tower(patches, tuple(grid))

    def n_image_tokens_for(self, grid) -> int:
        t, h, w = grid
        return t * h * w // (self.tower.merge ** 2)

    def get_mrope_positions(self, input_ids: List[int], grids: List[Tuple[int, int, int]]
                            ) -> Tuple[np.ndarray, int]:
        """[len, 3] (t, h, w) positions and the decode delta (HF
        get_rope_index, images only): text tokens count on from the last
        position, an image's tokens spread over its merged grid from there,
        and the text after it resumes at the image's start + max(t, h, w)."""
        m = self.tower.merge
        pos = np.zeros((len(input_ids), 3), np.int32)
        cur = i = gi = 0
        while i < len(input_ids):
            if input_ids[i] == self.image_token_index and gi < len(grids):
                t, h, w = grids[gi]
                gi += 1
                lh, lw = h // m, w // m
                n = t * lh * lw
                pos[i : i + n, 0] = cur + np.repeat(np.arange(t), lh * lw)
                pos[i : i + n, 1] = cur + np.tile(np.repeat(np.arange(lh), lw), t)
                pos[i : i + n, 2] = cur + np.tile(np.arange(lw), t * lh)
                cur += max(t, lh, lw)
                i += n
            else:
                pos[i] = cur
                cur += 1
                i += 1
        delta = int(pos.max() + 1 - len(input_ids)) if len(input_ids) else 0
        return pos, delta


class Qwen2_5_VLForConditionalGeneration(Qwen2VLForConditionalGeneration):
    """Qwen2.5-VL: Qwen2-VL's M-RoPE trunk with the window tower."""

    TOWER_CLS = Qwen25VisionTower
