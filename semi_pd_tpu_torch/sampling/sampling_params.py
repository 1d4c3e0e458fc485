"""User-facing sampling parameters (copy of
semi_pd_tpu/sampling/sampling_params.py).

Validation and defaults; the same field names as the reference's, so
OpenAI-adapter code maps 1:1. The grammar, penalty and logit-processor
fields are served: ``needs_penalties`` and ``needs_per_step_host`` route a
request to the masked or penalized step (runtime/scheduler.py)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Union


@dataclasses.dataclass
class SamplingParams:
    max_new_tokens: int = 128
    min_new_tokens: int = 0
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = -1
    min_p: float = 0.0
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    repetition_penalty: float = 1.0
    stop: Optional[Union[str, List[str]]] = None
    stop_token_ids: Optional[List[int]] = None
    ignore_eos: bool = False
    no_stop_trim: bool = False  # keep matched stop token/str in the text
    skip_special_tokens: bool = True
    spaces_between_special_tokens: bool = True
    n: int = 1
    # Constrained decoding (reference srt/constrained/)
    json_schema: Optional[str] = None
    regex: Optional[str] = None
    ebnf: Optional[str] = None
    # JSON string {"structures": [{begin, schema, end}], "triggers": [...]}
    # (reference sampling_params.py:72 + xgrammar_backend.py:162)
    structural_tag: Optional[str] = None
    # Named custom logit processor + its per-request params (TPU-native form
    # of reference custom_logit_processor.py — see sampling/logit_processor.py)
    custom_logit_processor: Optional[str] = None
    custom_params: Optional[Dict[str, Any]] = None

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError("temperature must be non-negative")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        if self.top_k == 0 or self.top_k < -1:
            raise ValueError("top_k must be -1 (disable) or >= 1")
        if not 0.0 <= self.min_p <= 1.0:
            raise ValueError("min_p must be in [0, 1]")
        if self.max_new_tokens < 0:
            raise ValueError("max_new_tokens must be >= 0")
        if isinstance(self.stop, str):
            self.stop = [self.stop]
        self.stop = self.stop or []
        self.stop_token_ids = list(self.stop_token_ids or [])
        n_constraints = sum(
            x is not None
            for x in (self.json_schema, self.regex, self.ebnf,
                      self.structural_tag)
        )
        if n_constraints > 1:
            raise ValueError(
                "at most one of json_schema/regex/ebnf/structural_tag may be set")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SamplingParams":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    @property
    def needs_per_step_host(self) -> bool:
        """True when sampling needs host-computed per-step inputs (penalty
        histograms or a custom logit-processor bias) — such requests take the
        synchronous decode path instead of the chained overlap ring."""
        return self.needs_penalties or self.custom_logit_processor is not None

    @property
    def needs_penalties(self) -> bool:
        return (
            self.frequency_penalty != 0.0
            or self.presence_penalty != 0.0
            or self.repetition_penalty != 1.0
        )
