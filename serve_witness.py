#!/usr/bin/env python3
"""Do greedy tokens differ between serving modes because of near ties, or
because of a fault? A witness run for one model on one CUDA card.

    python3 serve_witness.py                  # from the root of a checkout
    python3 serve_witness.py --f32-layers 0   # the bf16 part alone
    python3 serve_witness.py --model llama-3.2-1b-class --f32-layers 8
    python3 serve_witness.py --model meta-llama-3-8b --f32-layers 8

It serves chip_smoke.py's 32 greedy requests (prompts of 256-3072 tokens,
64 new tokens each, the bench's server settings) five times with one
engine: colocated, colocated again, semi-PD, semi-PD again, and colocated
with the streaming decode (``decode_stream``). First in bf16
at full width (random weights, seed 0; DeepSeek-V2-Lite by default, the
Llama-3.2-1B-class model of the chunked pool, or the Meta-Llama-3-8B
geometry of the aligned pool with fp8_e4m3 KV, as chip_smoke.py serves
each), then in float32 with float32 KV and the depth cut to
``--f32-layers`` (float32 weights of all 27 DeepSeek-V2-Lite layers do not
fit one 80 GB card beside the pool). For each pair of runs it prints the
share of requests whose 64 tokens are identical, where the first
difference falls, and the two runs' logprobs of their own chosen tokens
there: at a near tie the two picks are almost equally likely, so the gap
is as small as the noise on the logprobs of tokens both runs agree on.

A run that repeats its mode should give the same tokens (serving is
deterministic); the modes batch requests differently, and the streaming
decode sums in another order than the packed one, so bf16 rounding differs
between them, and float32 shrinks that rounding by 2^16. A fault in a
kernel at one mode's batch shapes would survive float32.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import statistics
import sys
import time

import numpy as np

from chip_smoke import (bench_server_args, deepseek_v2_lite_config, llama3_8b_config,
                        llama_1b_config, prompts_for, smi_line)

# model: (config, KV pool of the bf16 serves)
MODELS = {"deepseek-v2-lite": (deepseek_v2_lite_config, "auto"),
          "llama-3.2-1b-class": (llama_1b_config, "auto"),
          "meta-llama-3-8b": (llama3_8b_config, "fp8_e4m3")}


def serve(eng, semi_pd: bool, prompts, stream: bool = False, kv_cache_dtype: str = "auto"):
    """Tokens and their logprobs of every request, in prompt order; with
    ``stream`` decode batches take the pool's streaming decode."""
    import torch

    from semi_pd_tpu_torch.layers.attention import pool_attention
    from semi_pd_tpu_torch.runtime.scheduler import Scheduler
    from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams

    if not eng.flush_cache():
        raise AssertionError("engine not idle before serving")
    eng.server_args = bench_server_args(semi_pd, kv_cache_dtype, decode_stream=stream)
    eng.scheduler = Scheduler(eng.server_args, eng.runner)
    eng.runner.attention = pool_attention(eng.runner.kv_cache.buffer, stream=stream)
    sp = SamplingParams(max_new_tokens=64, temperature=0.0, ignore_eos=True)
    t0 = time.monotonic()
    outs = eng.generate(input_ids=prompts, sampling_params=sp, return_logprob=True)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    runs = []
    for o in outs:
        ids, lps = o["output_ids"], o["meta_info"]["output_logprobs"]
        if len(ids) != 64 or len(lps) != 64 or not np.isfinite(lps).all():
            raise AssertionError(f"request {o['rid']} incomplete or with NaN logprobs")
        runs.append((ids, lps))
    return runs, wall


def compare(a, b):
    """Share of identical requests; for the others the first differing
    position and |logprob gap| there; the logprob noise on agreed tokens."""
    same, first, gaps, noise = 0, [], [], []
    for (ia, la), (ib, lb) in zip(a, b):
        d = next((i for i, (x, y) in enumerate(zip(ia, ib)) if x != y), None)
        n = 64 if d is None else d
        noise += [abs(x - y) for x, y in zip(la[:n], lb[:n])]
        if d is None:
            same += 1
        else:
            first.append(d)
            gaps.append(abs(la[d] - lb[d]))
    stat = lambda v: None if not v else dict(median=statistics.median(v), max=max(v))
    return dict(same_requests=same / len(a), first_diff_pos=stat(first),
                gap_at_first_diff=stat(gaps), noise_on_agreed=stat(noise))


def witness(label, cfg, kv_cache_dtype="auto"):
    import torch

    from semi_pd_tpu_torch.runtime.engine import Engine

    t0 = time.monotonic()
    eng = Engine(bench_server_args(False, kv_cache_dtype), cfg)
    prompts = prompts_for(cfg.vocab_size)
    runs, walls = {}, {}
    for name, semi, stream in (("colocated", False, False), ("colocated_again", False, False),
                               ("semi_pd", True, False), ("semi_pd_again", True, False),
                               ("stream", False, True)):
        runs[name], walls[name] = serve(eng, semi, prompts, stream, kv_cache_dtype)
    pairs = {"colocated_vs_again": ("colocated", "colocated_again"),
             "semi_pd_vs_again": ("semi_pd", "semi_pd_again"),
             "colocated_vs_semi_pd": ("colocated", "semi_pd"),
             "colocated_vs_stream": ("colocated", "stream")}
    res = dict(model=label, dtype=cfg.dtype, kv_cache_dtype=kv_cache_dtype,
               layers=cfg.num_hidden_layers, wall_s=walls,
               seconds=time.monotonic() - t0,
               **{k: compare(runs[a], runs[b]) for k, (a, b) in pairs.items()})
    print("witness " + json.dumps(res), flush=True)
    del eng.scheduler, eng.runner
    gc.collect()
    torch.cuda.empty_cache()
    return res


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(MODELS), default="deepseek-v2-lite")
    ap.add_argument("--f32-layers", type=int, default=16,
                    help="depth of the float32 model (0: skip it)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("serve_witness: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 in full float32
    torch.backends.cudnn.allow_tf32 = False
    from semi_pd_tpu_torch.kernels import build_all

    print("setup " + json.dumps(dict(gpu=smi_line(), build_s=build_all())), flush=True)
    make_cfg, kv_cache_dtype = MODELS[args.model]
    cfg = make_cfg()
    witness(args.model, cfg, kv_cache_dtype)
    if args.f32_layers:
        witness(args.model, dataclasses.replace(
            cfg, dtype="float32", num_hidden_layers=args.f32_layers))
    print(smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
