"""Custom logit processors (copy of semi_pd_tpu/sampling/logit_processor.py,
which imports no JAX).

A processor is a *named, registered* object that contributes an additive
per-request logit-bias row, computed on the host from the request's visible
state (its generated ids and ``custom_params``); ``-inf`` bans a token. The
scheduler folds the rows of a batch, with any grammar's bans as ``-inf``,
into one float32 [B, V] array that rides the step's upload and is added to
the logits inside the step (``ops/sampling.sample``; on the card a decode
step with a bias replays its own CUDA graph). Pickled callables from the
wire are refused: processors are registered server-side by name.

Requests opt in via ``sampling_params.custom_logit_processor = "<name>"``
plus an optional ``custom_params`` dict. Built in: ``logit_bias``
(OpenAI-style ``{token_id: bias}``), ``disallow_tokens`` and
``thinking_budget``.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional

import numpy as np

_REGISTRY: Dict[str, "CustomLogitProcessor"] = {}


class CustomLogitProcessor(ABC):
    """Stateless processor: returns an additive bias row for one request."""

    name: str = ""

    @abstractmethod
    def bias(
        self,
        output_ids: List[int],
        custom_params: Optional[Dict[str, Any]],
        vocab_size: int,
    ) -> Optional[np.ndarray]:
        """float32 [vocab_size] additive bias (None = neutral this step)."""


def register_processor(proc: CustomLogitProcessor) -> CustomLogitProcessor:
    if not proc.name:
        raise ValueError("processor needs a non-empty .name")
    _REGISTRY[proc.name] = proc
    return proc


def resolve_processor(name: str) -> CustomLogitProcessor:
    proc = _REGISTRY.get(name)
    if proc is None:
        if len(name) > 128 or name.strip().startswith(("gASV", "gAWV", "\x80")):
            # Reference clients ship dill-pickled callables
            # (srt/sampling/custom_logit_processor.py to_str/from_str —
            # base64 pickle blobs). Deserializing arbitrary client
            # bytecode on the server is remote code execution by design;
            # this framework deliberately supports only named SERVER-SIDE
            # registry entries (see README "Custom logit processors").
            raise ValueError(
                "custom_logit_processor looks like a serialized (pickled) "
                "callable. Wire-pickled processors are rejected by design "
                "(arbitrary code execution); register the processor "
                "server-side via semi_pd_tpu_torch.sampling.logit_processor."
                "register_processor and pass its name instead. Registered: "
                f"{sorted(_REGISTRY)}"
            )
        raise ValueError(
            f"unknown custom logit processor {name!r}; registered: "
            f"{sorted(_REGISTRY)}"
        )
    return proc


class LogitBiasProcessor(CustomLogitProcessor):
    """OpenAI-style static logit_bias: custom_params = {"logit_bias":
    {token_id: float}}. Also backs the `logit_bias` field of the OpenAI
    endpoints (reference declares it in protocol.py:156 but never applies
    it; here it works)."""

    name = "logit_bias"

    def bias(self, output_ids, custom_params, vocab_size):
        table = (custom_params or {}).get("logit_bias") or {}
        if not table:
            return None
        row = np.zeros(vocab_size, np.float32)
        for tid, b in table.items():
            tid = int(tid)
            if 0 <= tid < vocab_size:
                row[tid] = float(b)
        return row


class DisallowTokensProcessor(CustomLogitProcessor):
    """Ban a token-id list outright: custom_params = {"token_ids": [...]}."""

    name = "disallow_tokens"

    def bias(self, output_ids, custom_params, vocab_size):
        ids = (custom_params or {}).get("token_ids") or []
        if not ids:
            return None
        row = np.zeros(vocab_size, np.float32)
        for tid in ids:
            tid = int(tid)
            if 0 <= tid < vocab_size:
                row[tid] = -np.inf
        return row


class ThinkingBudgetProcessor(CustomLogitProcessor):
    """Force an end-of-thinking token once the output hits a budget:
    custom_params = {"budget": N, "end_token_id": id}. (The reference repo's
    docs use exactly this example for custom logit processors.)"""

    name = "thinking_budget"

    def bias(self, output_ids, custom_params, vocab_size):
        p = custom_params or {}
        budget = int(p.get("budget", 0))
        end_id = int(p.get("end_token_id", -1))
        if end_id < 0 or end_id >= vocab_size or len(output_ids) < budget:
            return None
        if end_id in output_ids:
            return None  # already closed
        row = np.full(vocab_size, -np.inf, np.float32)
        row[end_id] = 0.0
        return row


register_processor(LogitBiasProcessor())
register_processor(DisallowTokensProcessor())
register_processor(ThinkingBudgetProcessor())
