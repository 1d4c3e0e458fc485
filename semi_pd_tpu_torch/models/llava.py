"""LLaVA-family vision-language models (port of semi_pd_tpu/models/llava.py):
LlavaForConditionalGeneration (also ``LlavaLlamaForCausalLM``),
YiVLForCausalLM and LlavaVidForCausalLM.

A CLIP tower (models/vision.py, float32), a two-layer projector with exact
GELU, and the port's ``LlamaForCausalLM`` built from the config's
``text_config``. ``encode_images`` turns [N, 3, H, W] pixels into
projected patch features [N, n_image_tokens, H_text] in float32 (the
projector's weights promoted to float32, as JAX promotes a float32 x bf16
product); the Engine splices them over the prompt's ``<image>``
placeholders (runtime/batch.py), so the language model's steps, their
kernels and the decode graphs are Llama's. Yi-VL adds a LayerNorm (eps
1e-5) after each projector linear; LLaVA-Vid encodes ``num_frames``
frames, mean-pools each frame's patch grid in ``mm_spatial_pool_stride``
squares (2 x 2) and projects them: ``n_image_tokens = num_frames * (side
// stride) ** 2``.

The parameter tree is the JAX model's, {"lm", "proj", "vision"}, leaf for
leaf; the runner reaches the language model's attributes (``page_size``,
``head``, ``dtype``, ``layer_windows`` ...) through the wrapper, as the
JAX class's ``__getattr__`` gives them (llava.py:39-60).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.models.llama import DTYPES, LlamaForCausalLM
from semi_pd_tpu_torch.models.params import TreeParams
from semi_pd_tpu_torch.models.vision import ClipVisionTower, cfg_get
from semi_pd_tpu_torch.ops.elementwise import layer_norm


class LlavaForConditionalGeneration(TreeParams):
    is_multimodal = True

    def __init__(self, config: ModelConfig, device):
        super().__init__()
        self.config = config
        hf = config.hf_config
        self.image_token_index = cfg_get(hf, "image_token_index", 32000)
        self.select_layer = cfg_get(hf, "vision_feature_layer", -2)
        self.tower = ClipVisionTower(cfg_get(hf, "vision_config"), device)
        # the language model of the text config (the outer config's fields
        # are the text config's: ModelConfig.from_hf_config's VLM clause)
        lm_cfg = ModelConfig.from_hf_config(cfg_get(hf, "text_config"),
                                            context_length=config.context_length,
                                            dtype=config.dtype)
        self.lm = LlamaForCausalLM(lm_cfg, device)
        Hv, Ht = self.tower.hidden, lm_cfg.hidden_size
        self.proj_shapes = {"fc1.w": (Hv, Ht), "fc1.b": (Ht,), "fc2.w": (Ht, Ht),
                            "fc2.b": (Ht,), **self._extra_proj(Ht)}
        self.proj = torch.nn.ParameterDict({
            k.replace(".", "__"): torch.nn.Parameter(
                torch.zeros(s, dtype=DTYPES[config.dtype], device=device), requires_grad=False)
            for k, s in self.proj_shapes.items()})

    def _extra_proj(self, Ht: int) -> dict:
        """Projector leaves beyond the two linears (Yi-VL's LayerNorms)."""
        return {}

    # the runner's view of the language model (JAX llava.py:39-60)
    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            if name == "lm":
                raise
            return getattr(self.lm, name)

    @property
    def page_size(self):
        return self.lm.page_size

    @page_size.setter
    def page_size(self, v):
        self.lm.page_size = v

    @property
    def n_image_tokens(self) -> int:
        return self.tower.n_patches

    # ------------------------------------------------------------- params
    def param_specs(self) -> List[Tuple[str, Tuple[int, ...]]]:
        return sorted([("lm." + p, s) for p, s in self.lm.param_specs()]
                      + [("proj." + p, s) for p, s in self.proj_shapes.items()]
                      + [("vision." + p, s) for p, s in self.tower.param_specs()])

    def leaf(self, path: str) -> torch.nn.Parameter:
        head, _, rest = path.partition(".")
        if head == "proj":
            return self.proj[rest.replace(".", "__")]
        return (self.lm if head == "lm" else self.tower).leaf(rest)

    def _p(self, name: str) -> torch.Tensor:
        """Projector leaf ``name`` in float32 (JAX promotes float32 x bf16)."""
        return self.proj[name.replace(".", "__")].float()

    # ------------------------------------------------------------- forward
    def encode_images(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """[N, 3, H, W] -> projected patch features [N, n_patches, Ht] (float32)."""
        feats = self.tower(pixel_values, self.select_layer)
        return self._project(feats)

    def _project(self, feats: torch.Tensor) -> torch.Tensor:
        x = F.gelu(feats @ self._p("fc1.w") + self._p("fc1.b"))
        return x @ self._p("fc2.w") + self._p("fc2.b")

    def forward(self, fb, kv_cache, attention=None, return_hidden=False, all_logits=False):
        return self.lm(fb, kv_cache, attention=attention, return_hidden=return_hidden,
                       all_logits=all_logits)

    def forward_embedding(self, fb, kv_cache, attention=None):
        return self.lm.forward_embedding(fb, kv_cache, attention)


class YiVLForCausalLM(LlavaForConditionalGeneration):
    """Yi-VL: LLaVA with a LayerNorm (eps 1e-5) after each projector linear
    (``proj.ln1`` / ``proj.ln2``; JAX llava.py:98-145)."""

    def _extra_proj(self, Ht: int) -> dict:
        return {"ln1.w": (Ht,), "ln1.b": (Ht,), "ln2.w": (Ht,), "ln2.b": (Ht,)}

    def _project(self, feats: torch.Tensor) -> torch.Tensor:
        ln = lambda x, n: layer_norm(x, {"w": self._p(n + ".w"), "b": self._p(n + ".b")}, 1e-5)
        x = ln(feats @ self._p("fc1.w") + self._p("fc1.b"), "ln1")
        x = F.gelu(x) @ self._p("fc2.w") + self._p("fc2.b")
        return ln(x, "ln2")


class LlavaVidForCausalLM(LlavaForConditionalGeneration):
    """LLaVA-Vid: ``num_frames`` frames (default 16) CLIP-encoded each,
    mean-pooled on the patch grid in ``mm_spatial_pool_stride`` squares
    (default 2), projected; one ``<image>`` expands to every frame's pooled
    tokens (JAX llava.py:148-245)."""

    def __init__(self, config: ModelConfig, device):
        super().__init__(config, device)
        hf = config.hf_config
        self.pool_stride = cfg_get(hf, "mm_spatial_pool_stride", 2)
        self.num_frames = cfg_get(hf, "num_frames", 16)

    @property
    def n_image_tokens(self) -> int:
        side = self.tower.image_size // self.tower.patch
        return self.num_frames * (side // self.pool_stride) ** 2

    def encode_images(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """[num_frames, 3, H, W] frames -> [num_frames, pooled, Ht]."""
        T = pixel_values.shape[0]
        if T != self.num_frames:
            raise ValueError(f"LlavaVid expects num_frames={self.num_frames} frames, got {T}")
        feats = self.tower(pixel_values, self.select_layer)  # [T, n_patches, Hv]
        side = self.tower.image_size // self.tower.patch
        s = self.pool_stride
        g = feats.reshape(T, side // s, s, side // s, s, feats.shape[-1])
        return self._project(g.mean(dim=(2, 4)).reshape(T, -1, feats.shape[-1]))
