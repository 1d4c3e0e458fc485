"""Sequence-classification and reward models (port of
semi_pd_tpu/models/classify.py): LlamaForSequenceClassification,
Gemma2ForSequenceClassification and Qwen2ForRewardModel.

A causal trunk whose lm_head gives way to a score head on each request's
last final-normed hidden state (``fb.logits_idx``), served through
``Engine.encode`` (``forward_embedding``), which returns the raw scores in
float32 [B, num_labels]:

- the two classifiers: a linear ``score.w`` [H, num_labels] (``num_labels``
  from the HF config, else the length of its ``id2label``, else 1) over
  Llama's or Gemma-2's ``_final_hidden`` (Gemma-2's: the embedding times
  sqrt(hidden) rounded to the model dtype, its sandwich-norm block with
  each layer's window, the (1 + w) final norm, as JAX :79-96);
- Qwen2's reward model: a qkv bias, a tied embedding, and the head
  ``Linear(H, H) -> ReLU -> Linear(H, 1)`` (``score.fc1`` / ``score.fc2``,
  JAX :99-153).

Their parameter trees are the JAX models': the trunk's without an lm_head,
and the score leaves. They produce no logits: ``forward`` raises, so the
Engine neither generates nor scores input log-probs with them.
"""

from __future__ import annotations

import torch

from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.layers.linear import apply_linear
from semi_pd_tpu_torch.models.gemma2 import Gemma2ForCausalLM
from semi_pd_tpu_torch.models.llama import LlamaForCausalLM
from semi_pd_tpu_torch.models.vision import cfg_get


def num_labels(hf_config) -> int:
    """The classifier's labels: ``num_labels``, else the length of
    ``id2label`` (as transformers' config classes derive it), else 1."""
    n = cfg_get(hf_config, "num_labels") if hf_config is not None else None
    if not n and hf_config is not None:
        n = len(cfg_get(hf_config, "id2label") or ())
    return int(n or 1)


class _ScoreHead:
    """Mixin: no lm_head, a score head, scores through forward_embedding."""

    def __init__(self, config: ModelConfig, device):
        config.is_embedding = True
        self.n_labels = num_labels(config.hf_config)
        super().__init__(config, device)
        self.lm_head = None

    def param_specs(self):
        specs = [s for s in super().param_specs() if not s[0].startswith("lm_head.")]
        return sorted(specs + self._score_specs())

    def _score_specs(self):
        return [("score.w", (self.config.hidden_size, self.n_labels))]

    def _score(self, h: torch.Tensor) -> torch.Tensor:
        return apply_linear(h, self.score)

    def forward(self, *args, **kwargs):
        raise NotImplementedError(
            f"{self.config.architecture} is a sequence classifier: it gives scores through "
            f"Engine.encode, no logits to generate or score with")

    def forward_embedding(self, fb, kv_cache: torch.Tensor, attention=None) -> torch.Tensor:
        """The scores of each request's last final-normed hidden state, in
        the model dtype, returned in float32 [B, num_labels]."""
        h = self._final_hidden(fb, kv_cache, attention)[fb.logits_idx.long()]
        return self._score(h).float()


class LlamaForSequenceClassification(_ScoreHead, LlamaForCausalLM):
    pass


class Gemma2ForSequenceClassification(_ScoreHead, Gemma2ForCausalLM):
    pass


class Qwen2ForRewardModel(_ScoreHead, LlamaForCausalLM):
    def __init__(self, config: ModelConfig, device):
        config.attention_bias = True
        config.tie_word_embeddings = True  # no lm_head in the checkpoint
        super().__init__(config, device)

    def _score_specs(self):
        H = self.config.hidden_size
        return [("score.fc1.b", (H,)), ("score.fc1.w", (H, H)),
                ("score.fc2.b", (1,)), ("score.fc2.w", (H, 1))]

    def _score(self, h: torch.Tensor) -> torch.Tensor:
        x = torch.relu(apply_linear(h, self.score_fc1, self.score_fc1_b))
        return apply_linear(x, self.score_fc2, self.score_fc2_b)
