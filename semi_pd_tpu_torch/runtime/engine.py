"""Offline in-process Engine API (trimmed port of
semi_pd_tpu/runtime/engine.py).

``Engine(server_args, model_config, device=...)`` builds the runner and the
scheduler; ``generate(input_ids=..., sampling_params=...)`` runs requests to
completion and returns dicts shaped like the JAX engine's. Text prompts,
tokenizers, sessions, LoRA, images, encode/score and weight updates are
later slices (ROADMAP A14, A16).
"""

from __future__ import annotations

import threading
import uuid
from typing import Any, Dict, List, Optional, Union

from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.config.server_args import ServerArgs
from semi_pd_tpu_torch.runtime.model_runner import ModelRunner
from semi_pd_tpu_torch.runtime.req import FinishReason, Req
from semi_pd_tpu_torch.runtime.scheduler import Scheduler
from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams


class Engine:
    def __init__(
        self,
        server_args: Optional[ServerArgs] = None,
        model_config: Optional[ModelConfig] = None,
        device: Optional[str] = None,
        decode_graphs: bool = True,
        **kwargs,
    ):
        """``decode_graphs``: ModelRunner's (on a CUDA device, decode steps
        replay CUDA graphs; False runs them eagerly); other keywords build
        the ServerArgs when none is given."""
        if model_config is None:
            raise NotImplementedError("loading a ModelConfig from a checkpoint "
                                      "path is ROADMAP A13; pass model_config")
        if server_args is None:
            server_args = ServerArgs(**kwargs)
        self.server_args = server_args
        self.runner = ModelRunner(server_args, model_config, device=device,
                                  decode_graphs=decode_graphs)
        self.scheduler = Scheduler(server_args, self.runner)
        self._eos_ids: List[int] = []  # no tokenizer / HF config in this slice
        self._lock = threading.Lock()

    # ---------------------------------------------------------------- API
    def make_request(
        self,
        input_ids: List[int],
        sampling_params: Optional[Union[SamplingParams, Dict]] = None,
        return_logprob: bool = False,
        top_logprobs_num: int = 0,
    ) -> Req:
        if isinstance(sampling_params, dict):
            sampling_params = SamplingParams.from_dict(sampling_params)
        sampling_params = sampling_params or SamplingParams()
        if not input_ids:
            raise ValueError("input is empty (no prompt tokens)")
        req = Req(
            rid=uuid.uuid4().hex,
            input_ids=list(input_ids),
            sampling_params=sampling_params,
            eos_token_ids=self._eos_ids,
            return_logprob=return_logprob,
            top_logprobs_num=int(top_logprobs_num or 0),
        )
        return req

    def generate(
        self,
        prompt: Optional[Union[str, List[str]]] = None,
        input_ids: Optional[Union[List[int], List[List[int]]]] = None,
        sampling_params: Optional[Union[SamplingParams, Dict]] = None,
        return_logprob: bool = False,
        top_logprobs_num: int = 0,
    ) -> Union[Dict, List[Dict]]:
        """Synchronous batch generation over token ids."""
        if prompt is not None:
            raise NotImplementedError("text prompts need a tokenizer (ROADMAP A16); "
                                      "pass input_ids")
        if input_ids is None:
            raise ValueError("provide input_ids")
        single = bool(input_ids) and isinstance(input_ids[0], int)
        if single:
            input_ids = [input_ids]
        reqs = [
            self.make_request(ids, sampling_params, return_logprob=return_logprob,
                              top_logprobs_num=top_logprobs_num)
            for ids in input_ids
        ]
        with self._lock:
            for r in reqs:
                self.scheduler.add_request(r)
            self._run_until_done(reqs)
        outs = [self._to_output(r) for r in reqs]
        return outs[0] if single else outs

    def _run_until_done(self, reqs: List[Req]) -> None:
        pending = {r.rid for r in reqs if not r.finished}
        guard = 0
        while pending:
            produced = self.scheduler.tick()
            for req, tok in produced:
                if tok >= 0 and req.finished:
                    pending.discard(req.rid)
            if not produced:
                guard += 1
                if guard > 10000 or not self.scheduler.has_work():
                    break
            else:
                guard = 0
        for r in reqs:
            if not r.finished:
                r.finish_reason = FinishReason.ABORT

    def _to_output(self, req: Req) -> Dict[str, Any]:
        return {
            "rid": req.rid,
            "text": req.decoded_text,
            "output_ids": req.full_output_ids(),
            "meta_info": {
                "prompt_tokens": req.origin_prompt_len,
                "completion_tokens": len(req.output_ids) + req.n_retracted_output,
                "finish_reason": req.finish_reason.value,
                "cached_tokens": req.cached_tokens,
                "output_logprobs": req.output_logprobs if req.return_logprob else None,
                "output_top_logprobs": None,
            },
        }

    # ---------------------------------------------------------- maintenance
    def flush_cache(self) -> bool:
        """Drop the prefix cache (only when idle) and check for leaks."""
        self.scheduler.drain()
        if self.scheduler.has_work():
            return False
        self.scheduler.tree_cache.evict(10**9)
        self.scheduler.check_memory()
        return True

    def release_memory_occupation(self) -> bool:
        """Free the KV pools' device memory between rollout phases (the
        draft pool's too); only when idle, like flush_cache."""
        if not self.flush_cache():
            return False
        self.runner.release_kv_memory()
        return True

    def resume_memory_occupation(self) -> bool:
        self.runner.resume_kv_memory()
        return True

    def get_server_info(self) -> Dict[str, Any]:
        s = self.scheduler
        return {
            "model_path": self.server_args.model_path,
            "is_semi_pd": self.server_args.enable_semi_pd,
            "device": str(self.runner.device),
            "num_running": len(s.running),
            "num_waiting": len(s.waiting),
            "finished": s.n_finished,
            "retracted": s.n_retracted,
            "prefill_tokens": s.n_prefill_tokens,
            "decode_tokens": s.n_decode_tokens,
            "cached_prefix_tokens": s.n_cached_prefix_tokens,
            "kv_pages_free": self.runner.page_allocator.available_pages(),
            "kv_pages_total": self.runner.page_allocator.usable_pages,
        }
