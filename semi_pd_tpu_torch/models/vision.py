"""CLIP vision tower (port of semi_pd_tpu/models/vision.py:24-139
ClipVisionTower): LLaVA's, Yi-VL's and LLaVA-Vid's image encoder.

A ViT with full (non-causal) attention over the patches, pre-norm blocks
with quick-GELU: the patch conv (weight HWIO [p, p, 3, Hd], stride p,
valid padding), the class token prepended, learned positions added, the
pre-LayerNorm, then ``select_layer``'s blocks (LLaVA's -2: all but the
last), the class token dropped. It computes in float32, as the JAX tower
does (``vision.py:34``), with plain torch ops (a conv, matmuls, softmax):
the JAX package computes it outside Pallas, so it has no kernel. Its
parameter tree is the JAX tower's leaf for leaf; the vision config is a
HuggingFace CLIP vision config, a dict or an object.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from semi_pd_tpu_torch.models.params import TreeParams
from semi_pd_tpu_torch.ops.elementwise import layer_norm


def cfg_get(cfg, key: str, default=None):
    """Key ``key`` of a config given as a dict or as an object."""
    if isinstance(cfg, dict):
        return cfg.get(key, default)
    return getattr(cfg, key, default)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class ClipVisionTower(TreeParams):
    def __init__(self, vision_config, device):
        super().__init__()
        g = lambda k, d=None: cfg_get(vision_config, k, d)
        self.hidden = g("hidden_size", 1024)
        self.inter = g("intermediate_size", 4096)
        self.layers = g("num_hidden_layers", 24)
        self.heads = g("num_attention_heads", 16)
        self.head_dim = self.hidden // self.heads
        self.image_size = g("image_size", 336)
        self.patch = g("patch_size", 14)
        self.n_patches = (self.image_size // self.patch) ** 2
        self.eps = g("layer_norm_eps", 1e-5)
        self.dtype = torch.float32
        self.make_leaves(self.dtype, device)

    def param_specs(self) -> List[Tuple[str, Tuple[int, ...]]]:
        Hd, L, I = self.hidden, self.layers, self.inter
        specs = [("patch_embed.w", (self.patch, self.patch, 3, Hd)),
                 ("class_embed", (Hd,)), ("pos_embed", (self.n_patches + 1, Hd)),
                 ("pre_ln.w", (Hd,)), ("pre_ln.b", (Hd,))]
        for name, din, dout in (("qkv", Hd, 3 * Hd), ("out", Hd, Hd), ("fc1", Hd, I),
                                ("fc2", I, Hd)):
            specs += [(f"layers.{name}.w", (L, din, dout)), (f"layers.{name}.b", (L, dout))]
        for ln in ("ln1", "ln2"):
            specs += [(f"layers.{ln}.w", (L, Hd)), (f"layers.{ln}.b", (L, Hd))]
        return sorted(specs)

    def _ln(self, x: torch.Tensor, name: str, layer=None) -> torch.Tensor:
        w, b = self.leaf(name + ".w"), self.leaf(name + ".b")
        if layer is not None:
            w, b = w[layer], b[layer]
        return layer_norm(x, {"w": w, "b": b}, self.eps)

    def _lin(self, x: torch.Tensor, name: str, layer: int) -> torch.Tensor:
        return x @ self.leaf(f"layers.{name}.w")[layer] + self.leaf(f"layers.{name}.b")[layer]

    def forward(self, pixel_values: torch.Tensor, select_layer: int = -2) -> torch.Tensor:
        """pixel_values [N, 3, H, W] -> patch features [N, n_patches, hidden]
        (float32) from block ``select_layer``, the class token dropped."""
        x = pixel_values.to(self.dtype)
        N = x.shape[0]
        w = self.leaf("patch_embed.w").permute(3, 2, 0, 1)  # HWIO -> OIHW
        patches = F.conv2d(x, w, stride=self.patch)  # [N, Hd, gh, gw]
        patches = patches.flatten(2).transpose(1, 2).reshape(N, self.n_patches, self.hidden)
        cls = self.leaf("class_embed").expand(N, 1, self.hidden)
        h = torch.cat([cls, patches], dim=1) + self.leaf("pos_embed")[None]
        h = self._ln(h, "pre_ln")
        n_run = self.layers + select_layer + 1 if select_layer < 0 else select_layer + 1
        S = h.shape[1]
        for layer in range(n_run):
            y = self._ln(h, "layers.ln1", layer)
            q, k, v = self._lin(y, "qkv", layer).split(self.hidden, dim=-1)
            q, k, v = (t.reshape(N, S, self.heads, self.head_dim) for t in (q, k, v))
            scores = torch.einsum("nqhd,nkhd->nhqk", q, k) / self.head_dim ** 0.5
            attn = torch.einsum("nhqk,nkhd->nqhd", torch.softmax(scores, -1), v)
            h = h + self._lin(attn.reshape(N, S, self.hidden), "out", layer)
            y = quick_gelu(self._lin(self._ln(h, "layers.ln2", layer), "fc1", layer))
            h = h + self._lin(y, "fc2", layer)
        return h[:, 1:, :]
