"""Offline in-process Engine API (trimmed port of
semi_pd_tpu/runtime/engine.py).

``Engine(server_args, model_config, tokenizer=..., device=...)`` builds the
runner and the scheduler; ``generate(input_ids=..., sampling_params=...)``
runs requests to completion and returns dicts shaped like the JAX engine's,
with per-token and top-k log-probs on request, and with ``return_logprob``
and ``max_new_tokens=0`` scores the prompts instead. ``score`` gives
teacher-forced input log-probs (with a top-k), ``encode`` pooled
embeddings (``is_embedding`` engines refuse to generate). The tokenizer
object builds the grammar compiler of constrained requests (json_schema,
regex, ebnf, structural_tag) and gives its EOS id, as in the JAX engine.

Images (JAX engine.py:159-245, :279-357): ``generate(..., image_data=)``
takes, per request, an image or a list of them, each a normalized numpy
``[3, H, W]`` array (a Qwen-VL model patchifies it) or, for Qwen-VL, the
HF processor's dict of ``pixel_values`` / ``image_grid_thw``; LLaVA-Vid
takes its frames as one request's list. Each ``<image>`` token of the
prompt becomes ``n_image_tokens`` placeholders (a Qwen-VL image's
``n_image_tokens_for(grid)``), the runner's tower encodes the images on
the device, and the prefill splices the features over the placeholders;
Qwen-VL requests carry their M-RoPE positions. ``input_embeds`` gives a
prompt as embedding rows [n, hidden] (no ids), spliced the same way.
Encoded images (a base64 string, bytes, a PIL image) need the checkpoint's
image processor, which is ROADMAP A13. Text prompts, detokenization,
sessions, LoRA and weight updates are later slices (ROADMAP A13-A16).
"""

from __future__ import annotations

import os
import threading
import uuid
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.config.server_args import ServerArgs
from semi_pd_tpu_torch.runtime.batch import build_extend_batch
from semi_pd_tpu_torch.runtime.model_runner import ModelRunner
from semi_pd_tpu_torch.runtime.req import FinishReason, Req
from semi_pd_tpu_torch.runtime.scheduler import Scheduler
from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams


def _refuse_text(prompt) -> None:
    if prompt is not None:
        raise NotImplementedError("text prompts are ROADMAP A16 (the tokenizer object serves "
                                  "the grammar compiler only); pass input_ids")


class Engine:
    def __init__(
        self,
        server_args: Optional[ServerArgs] = None,
        model_config: Optional[ModelConfig] = None,
        tokenizer=None,
        device: Optional[str] = None,
        decode_graphs: bool = True,
        **kwargs,
    ):
        """``tokenizer``: an object with ``decode(ids)`` and a vocabulary
        size (``vocab_size`` / ``len``), and optionally ``eos_token_id`` and
        ``all_special_ids``, for the grammar compiler; ``decode_graphs``:
        ModelRunner's (on a CUDA device, decode steps replay CUDA graphs;
        False runs them eagerly); other keywords build the ServerArgs when
        none is given."""
        if model_config is None:
            raise NotImplementedError("loading a ModelConfig from a checkpoint "
                                      "path is ROADMAP A13; pass model_config")
        if server_args is None:
            server_args = ServerArgs(**kwargs)
        self.server_args = server_args
        self.runner = ModelRunner(server_args, model_config, device=device,
                                  decode_graphs=decode_graphs)
        self.scheduler = Scheduler(server_args, self.runner)
        self.tokenizer = tokenizer
        # the tokenizer's EOS (no HF config in this slice: ROADMAP A13)
        eos = getattr(tokenizer, "eos_token_id", None)
        self._eos_ids: List[int] = [] if eos is None else [int(eos)]
        self._lock = threading.Lock()
        self._grammar_compiler = None  # lazy: the vocab's string table is costly

    def _get_grammar_compiler(self):
        if self._grammar_compiler is None:
            if self.tokenizer is None:
                raise ValueError("grammar-constrained decoding needs a tokenizer")
            from semi_pd_tpu_torch.constrained.grammar import GrammarCompiler

            cache_dir = None
            if not self.server_args.disable_outlines_disk_cache:
                cache_dir = os.path.join(os.path.expanduser("~"), ".cache",
                                         "semi_pd_tpu_torch", "grammar")
            self._grammar_compiler = GrammarCompiler(
                self.tokenizer, self._eos_ids,
                json_whitespace_pattern=self.server_args.constrained_json_whitespace_pattern,
                disk_cache_dir=cache_dir,
            )
        return self._grammar_compiler

    # ---------------------------------------------------------------- API
    def make_request(
        self,
        input_ids: Optional[List[int]],
        sampling_params: Optional[Union[SamplingParams, Dict]] = None,
        return_logprob: bool = False,
        top_logprobs_num: int = 0,
        image_data=None,
        input_embeds=None,
    ) -> Req:
        if isinstance(sampling_params, dict):
            sampling_params = SamplingParams.from_dict(sampling_params)
        sampling_params = sampling_params or SamplingParams()
        if self.server_args.is_embedding and sampling_params.max_new_tokens:
            # encode() / score() requests carry max_new_tokens=0 and pass
            raise ValueError("engine is in embedding mode (is_embedding); use encode()")
        if input_embeds is not None:
            # a prompt given as embedding rows: placeholder ids, every row
            # spliced, kept out of the radix cache (the JAX checks)
            if image_data is not None:
                raise ValueError("input_embeds and image_data are exclusive")
            if input_ids is not None:
                raise ValueError("input_embeds replaces the prompt; do not pass "
                                 "prompt/input_ids alongside it")
            embeds = np.asarray(input_embeds, dtype=np.float32)
            if embeds.ndim != 2 or embeds.shape[0] == 0:
                raise ValueError(f"input_embeds must be [num_tokens, hidden], got "
                                 f"{embeds.shape}")
            hidden = self.runner.model_config.hidden_size
            if embeds.shape[1] != hidden:
                raise ValueError(f"input_embeds hidden dim {embeds.shape[1]} != model "
                                 f"hidden size {hidden}")
            input_ids = [0] * embeds.shape[0]
        if input_ids is None:
            raise ValueError("provide input_ids")
        if image_data is not None:
            input_ids = self._expand_image_tokens(list(input_ids), image_data)
        if not input_ids:
            raise ValueError("input is empty (no prompt tokens)")
        req = Req(
            rid=uuid.uuid4().hex,
            input_ids=list(input_ids),
            sampling_params=sampling_params,
            eos_token_ids=self._eos_ids,
            # top-k log-probs imply per-token log-probs; k capped at 32
            return_logprob=return_logprob or top_logprobs_num > 0,
            top_logprobs_num=min(max(int(top_logprobs_num or 0), 0), 32),
        )
        if input_embeds is not None:
            req.input_embeds = True
            req.mm_embeds = torch.from_numpy(embeds).to(self.runner.device)
            req.mm_positions = np.arange(embeds.shape[0])
        if image_data is not None:
            self._attach_images(req, image_data)
        sp = sampling_params
        if sp.json_schema or sp.regex or sp.ebnf or sp.structural_tag:
            gc = self._get_grammar_compiler()
            if sp.regex:
                req.grammar = gc.matcher("regex", sp.regex)
            elif sp.json_schema:
                req.grammar = gc.matcher("json_schema", sp.json_schema)
            elif sp.structural_tag:
                req.grammar = gc.matcher("structural_tag", sp.structural_tag)
            else:
                req.grammar = gc.matcher("ebnf", sp.ebnf)
        if sp.custom_logit_processor is not None:
            # every registered processor is served (no pickled callables)
            from semi_pd_tpu_torch.sampling.logit_processor import resolve_processor

            resolve_processor(sp.custom_logit_processor)  # fail fast on a typo
        return req

    # ---------------------------------------------------------------- images
    def _expand_image_tokens(self, ids: List[int], image_data) -> List[int]:
        """Each ``<image>`` placeholder repeated ``n_image_tokens`` times (a
        Qwen-VL image: its grid's merged tokens), so that the prompt's
        length is that of the spliced features."""
        model = self.runner.model
        if not getattr(model, "is_multimodal", False):
            raise ValueError("model is not multimodal")
        tok_id = model.image_token_index
        if hasattr(model, "patchify"):
            imgs = image_data if isinstance(image_data, list) else [image_data]
            grids = [self._qwen_vl_patches(i)[1] for i in imgs]
            out, k = [], 0
            for t in ids:
                if t == tok_id and k < len(grids):
                    out.extend([tok_id] * model.n_image_tokens_for(grids[k]))
                    k += 1
                else:
                    out.append(t)
            return out
        out = []
        for t in ids:
            out.extend([tok_id] * model.n_image_tokens if t == tok_id else [t])
        return out

    def _qwen_vl_patches(self, item):
        """(flattened patches, grid) of a Qwen-VL image: the HF processor's
        dict as it is, a raw array patchified."""
        if isinstance(item, dict):
            grid = tuple(int(x) for x in np.asarray(item["image_grid_thw"]).reshape(-1)[:3])
            return np.asarray(item["pixel_values"], np.float32), grid
        return self.runner.model.patchify(self._load_image(item))

    @staticmethod
    def _load_image(item) -> np.ndarray:
        """A normalized pixel array [3, H, W]; an encoded image needs the
        checkpoint's image processor (ROADMAP A13)."""
        if isinstance(item, np.ndarray):
            return item.astype(np.float32)
        raise NotImplementedError(
            f"an image given as {type(item).__name__}: decoding and normalizing it needs the "
            f"checkpoint's image processor (ROADMAP A13); pass a normalized numpy "
            f"[3, H, W] array")

    def _attach_images(self, req: Req, image_data) -> None:
        """Encode the request's images on the device and map their rows to
        the prompt's placeholders (row k at the k-th one), with a Qwen-VL
        request's M-RoPE positions."""
        model = self.runner.model
        imgs = image_data if isinstance(image_data, list) else [image_data]
        if hasattr(model, "patchify"):
            feats, grids = [], []
            for i in imgs:
                patches, grid = self._qwen_vl_patches(i)
                grids.append(grid)
                feats.append(self.runner.encode_images_patches(patches, grid))
            flat = torch.cat(feats, dim=0)
            req.mrope_pos, req.mrope_delta = model.get_mrope_positions(req.input_ids, grids)
        else:
            px = np.stack([self._load_image(i) for i in imgs])
            embeds = self.runner.encode_images(px)  # [N, n_patches, H]
            flat = embeds.reshape(-1, embeds.shape[-1])
        ids = np.asarray(req.input_ids)
        positions = np.flatnonzero(ids == model.image_token_index)[: flat.shape[0]]
        req.mm_embeds = flat
        req.mm_positions = positions

    def generate(
        self,
        prompt: Optional[Union[str, List[str]]] = None,
        input_ids: Optional[Union[List[int], List[List[int]]]] = None,
        sampling_params: Optional[Union[SamplingParams, Dict]] = None,
        return_logprob: bool = False,
        top_logprobs_num: int = 0,
        image_data=None,
        input_embeds=None,
    ) -> Union[Dict, List[Dict]]:
        """Synchronous batch generation over token ids (or embedding rows:
        ``input_embeds``, one [n, hidden] prompt or a list of them), with
        ``image_data`` per request (module docstring). With
        ``return_logprob`` and ``max_new_tokens=0`` it scores the prompts
        (``score``) instead."""
        if self.server_args.is_embedding:
            raise ValueError("engine is in embedding mode (is_embedding); use encode()")
        sp = sampling_params
        mnt = (sp.get("max_new_tokens") if isinstance(sp, dict)
               else getattr(sp, "max_new_tokens", None))
        if return_logprob and mnt == 0:
            lps = self.score(prompt=prompt, input_ids=input_ids)
            mk = lambda l: {"text": "", "output_ids": [],
                            "meta_info": {"input_token_logprobs": l}}
            return mk(lps) if input_ids and isinstance(input_ids[0], int) else [
                mk(l) for l in lps]
        _refuse_text(prompt)
        if input_embeds is not None:
            first = input_embeds[0]
            single = np.ndim(first) == 1 or not isinstance(first, (list, np.ndarray))
            input_embeds = [np.asarray(e, np.float32)
                            for e in ([input_embeds] if single else input_embeds)]
            if input_ids is not None:
                raise ValueError("input_embeds replaces the prompt; do not pass "
                                 "prompt/input_ids alongside it")
            input_ids = [None] * len(input_embeds)
        elif input_ids is None:
            raise ValueError("provide input_ids")
        else:
            single = bool(input_ids) and isinstance(input_ids[0], int)
            if single:
                input_ids = [input_ids]
        reqs = [
            self.make_request(
                ids, sampling_params, return_logprob=return_logprob,
                top_logprobs_num=top_logprobs_num,
                image_data=(image_data[i] if isinstance(image_data, list) and not single
                            else image_data),
                input_embeds=None if input_embeds is None else input_embeds[i])
            for i, ids in enumerate(input_ids)
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
                # per position: ([top-k logprobs], [top-k token ids])
                "output_top_logprobs": (
                    req.output_top_logprobs if req.top_logprobs_num else None),
            },
        }

    # ------------------------------------------------------ encode / score
    def _prefill_whole(self, input_ids):
        """Requests of ``input_ids`` (one list, or a list of lists) that
        take no new token, each given a slot and the pages of its whole
        prompt, and the extend batch of them all. Returns (reqs, hb,
        single)."""
        if input_ids is None:
            raise ValueError("provide input_ids")
        single = bool(input_ids) and isinstance(input_ids[0], int)
        if single:
            input_ids = [input_ids]
        sched = self.scheduler
        reqs = []
        for ids in input_ids:
            r = self.make_request(ids, SamplingParams(max_new_tokens=0))
            slot = self.runner.req_pool.alloc()
            pages = sched._alloc_pages(-(-len(ids) // sched.page_size))
            if slot is None or pages is None:
                raise RuntimeError("out of KV memory for encode / score")
            r.req_slot = slot
            r.pages = pages.tolist()
            self.runner.req_pool.write(slot, 0, pages)
            reqs.append(r)
        hb = build_extend_batch([(r, r.prompt_len) for r in reqs],
                                self.runner.req_pool.page_table, sched.page_size,
                                sched.t_buckets, sched.b_buckets, sched.p_buckets)
        return reqs, hb, single

    def encode(self, prompt=None, input_ids=None):
        """Embeddings: per request the normalized final hidden state of its
        last token, a list of ``hidden_size`` floats."""
        _refuse_text(prompt)
        with self._lock:
            reqs, hb, single = self._prefill_whole(input_ids)
            emb = self.runner.encode_step_host(hb).cpu().numpy()
            out = [emb[i].tolist() for i in range(len(reqs))]
            for r in reqs:
                self.scheduler._free_req_memory(r)
        return out[0] if single else out

    def score(self, prompt=None, input_ids=None, logprob_start_len: int = 0,
              top_logprobs_num: int = 0):
        """Teacher-forced input-token log-probs: per request a list of
        (logprob, token_id) for input positions >= logprob_start_len
        (position 0 has none; the start is clamped to 1). With
        ``top_logprobs_num`` > 0 (capped at 32) each entry is (logprob,
        token_id, ([top-k logprobs], [top-k ids]))."""
        _refuse_text(prompt)
        with self._lock:
            reqs, hb, single = self._prefill_whole(input_ids)
            # targets[t]: the next input token of the same request (rows are
            # the requests' prompts in order)
            targets = np.zeros(hb.T, np.int32)
            off = 0
            for r in reqs:
                n = r.prompt_len
                targets[off : off + n - 1] = r.input_ids[1:]
                off += n
            k = min(max(int(top_logprobs_num or 0), 0), 32)
            if k > 0:
                lp, tv, ti = self.runner.read_round(*self.runner.score_topk_host(hb, targets, k))
            else:
                (lp,) = self.runner.read_round(self.runner.score_step_host(hb, targets))
            out = []
            off = 0
            start = max(1, logprob_start_len)
            for r in reqs:
                n = r.prompt_len
                # the log-prob of the token at position i sits at row off + i - 1
                if k > 0:
                    out.append([(float(lp[off + i - 1]), int(r.input_ids[i]),
                                 (tv[off + i - 1].tolist(), ti[off + i - 1].tolist()))
                                for i in range(start, n)])
                else:
                    out.append([(float(lp[off + i - 1]), int(r.input_ids[i]))
                                for i in range(start, n)])
                off += n
                self.scheduler._free_req_memory(r)
        return out[0] if single else out

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
