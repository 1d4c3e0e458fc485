"""Request lifecycle state machine (trimmed copy of
semi_pd_tpu/runtime/req.py).

Host-side only: tokens and page lists are python/numpy; device state lives
in the shared KV pool addressed through ``pages``. ``spec_hidden`` seeds
EAGLE's draft; ``grammar`` is the request's grammar cursor
(constrained/grammar.py), ``kv_debt`` the jump-forward tokens whose KV is
owed; ``mm_embeds`` / ``mm_positions`` / ``input_embeds`` /
``mrope_pos`` / ``mrope_delta`` carry an image prompt (or one given as
embeddings) and Qwen-VL's M-RoPE positions. The LoRA, detokenizer and
DP-attention fields are not in this slice.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Any, List, Optional

from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams


class FinishReason(enum.Enum):
    NONE = None
    LENGTH = "length"
    EOS = "stop"  # eos token
    STOP_TOKEN = "stop_token"
    STOP_STR = "stop_str"
    ABORT = "abort"


@dataclasses.dataclass(eq=False)  # identity semantics: scheduler compares
class Req:  # batch membership by object, and dicts key on rid
    rid: str
    input_ids: List[int]
    sampling_params: SamplingParams
    eos_token_ids: List[int] = dataclasses.field(default_factory=list)

    # Output state
    output_ids: List[int] = dataclasses.field(default_factory=list)
    output_logprobs: List[float] = dataclasses.field(default_factory=list)
    return_logprob: bool = False
    top_logprobs_num: int = 0
    # per generated position: ([top-k logprobs], [top-k token ids])
    output_top_logprobs: List[Any] = dataclasses.field(default_factory=list)

    # Memory state (single-owner: assigned by the scheduler)
    req_slot: Optional[int] = None  # row in ReqToPagePool
    pages: List[int] = dataclasses.field(default_factory=list)  # page ids, in order
    n_prefix_pages: int = 0  # leading pages borrowed from the radix cache
    last_node: Any = None  # radix tree node holding our prefix lock

    # Prefill progress (chunked prefill)
    prefilled_len: int = 0  # prompt tokens whose KV is already in the pool
    cached_tokens: int = 0  # prefix tokens reused from the radix cache
    # Output tokens emitted WITHOUT a model forward (grammar jump-forward);
    # their KV is owed and back-filled by an extend before the next decode.
    kv_debt: int = 0

    # Lifecycle
    finish_reason: FinishReason = FinishReason.NONE
    # Bumped whenever host state diverges from in-flight device steps
    # (retraction, jump-forward re-queue): ring entries capture the epoch at
    # dispatch and discard rows whose request has since moved on.
    epoch: int = 0
    n_retracted_output: int = 0  # generated tokens folded into input by retraction
    queue_time: float = dataclasses.field(default_factory=time.monotonic)
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None

    decoded_text: str = ""

    # Grammar-constrained decoding state (set when sampling_params has a
    # json_schema / regex / ebnf / structural_tag)
    grammar: Any = None

    # EAGLE: the target's hidden state [H] (float32 numpy) at the last
    # committed token, which seeds the next round's draft; None until the
    # prompt's last chunk ran with the hidden state returned
    spec_hidden: Any = None

    # The image path (JAX req.py:56-57, :98-104): the rows that replace the
    # placeholder tokens' embeddings ([n_mm, H], a tensor on the step device:
    # image features as the tower made them, or an input_embeds prompt in
    # float32), the sorted prompt positions they replace (row k at
    # mm_positions[k]; the JAX request keeps a {position: row} dict), and
    # whether the prompt was given as embeddings; Qwen-VL's (t, h, w) rope
    # positions of the prompt [len, 3] and the decode offset (rope position
    # = position + mrope_delta past the prompt)
    mm_embeds: Any = None
    mm_positions: Any = None
    input_embeds: bool = False
    mrope_pos: Any = None
    mrope_delta: int = 0

    # Original prompt length (input_ids grows when retraction folds generated
    # tokens back into the prefill input).
    origin_prompt_len: int = -1

    def __post_init__(self):
        if self.origin_prompt_len < 0:
            self.origin_prompt_len = len(self.input_ids)

    @property
    def prompt_len(self) -> int:
        return len(self.input_ids)

    def full_output_ids(self) -> List[int]:
        """All generated tokens, including any folded into input_ids by
        retraction."""
        return (self.input_ids + self.output_ids)[self.origin_prompt_len :]

    @property
    def kv_len(self) -> int:
        """Tokens whose KV currently sits in the pool. The most recently
        sampled token's KV is written by the *next* decode step (its embedding
        is that step's input), hence the -1."""
        return self.prefilled_len + max(0, len(self.output_ids) - 1) - self.kv_debt

    @property
    def prefill_remaining(self) -> int:
        return self.prompt_len - self.prefilled_len

    @property
    def finished(self) -> bool:
        return self.finish_reason is not FinishReason.NONE

    def all_token_ids(self) -> List[int]:
        return self.input_ids + self.output_ids

    def check_finished(self) -> None:
        if self.finished:
            return
        sp = self.sampling_params
        n_out = len(self.output_ids) + self.n_retracted_output
        if n_out >= sp.max_new_tokens:
            self.finish_reason = FinishReason.LENGTH
            return
        if n_out < sp.min_new_tokens:
            return
        if self.grammar is not None and self.grammar.finished:
            # the matcher terminated: no further token is grammatical (the
            # sampler skips a finished grammar's mask, so decoding on would
            # append unconstrained tokens to a valid match)
            self.finish_reason = FinishReason.STOP_TOKEN
            return
        last = self.output_ids[-1] if self.output_ids else None
        if last is not None:
            if not sp.ignore_eos and last in self.eos_token_ids:
                self.finish_reason = FinishReason.EOS
                return
            if last in sp.stop_token_ids:
                self.finish_reason = FinishReason.STOP_TOKEN
                return

    def reset_for_retract(self) -> None:
        """Return to the waiting queue after decode-OOM retraction.
        Generated tokens become part of the input for re-prefill."""
        self.input_ids = self.all_token_ids()
        self.n_retracted_output += len(self.output_ids)
        self.output_ids = []
        self.prefilled_len = 0
        self.kv_debt = 0
        self.pages = []
        self.n_prefix_pages = 0
        self.req_slot = None
        self.last_node = None
        self.spec_hidden = None
        self.epoch += 1
