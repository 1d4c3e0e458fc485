#!/usr/bin/env python3
"""Where a full-width decode step's time goes, on one CUDA card, eager and
replayed from a CUDA graph.

    python3 decode_trace.py        # from the root of a checkout; needs one CUDA card

For the Llama-3.2-1B-class model (chunked pool, bf16 KV), the
Meta-Llama-3-8B geometry (aligned pool, fp8_e4m3 KV) and DeepSeek-V2-Lite
(latent pool, MLA + MoE), at full width with random weights and the
bench's server settings (chip_smoke.py), it builds one decode batch of 32
requests of 256-3136 KV positions (seed 0) and runs the runner's decode
step (``ModelRunner.step_packed_raw``: the model, sampling and log-probs)
with the packed and with the streaming decode (``decode_stream``), each
eagerly (the runner's graphs off) and replayed from its CUDA graph, in
turns (eager, graph, graph, eager). For each it prints one ``trace`` JSON
line: the host wall per step (20 steps ended by a synchronise, per turn),
the device time per step summed over every kernel in a torch.profiler
trace of 5 steps, the device's busy share of the step (device time over
the mean host wall), and the kernels that take the most device time. It
imports nothing of JAX.
"""

from __future__ import annotations

import gc
import json
import statistics
import sys
import time

import numpy as np

from chip_smoke import (bench_server_args, deepseek_v2_lite_config, llama3_8b_config,
                        llama_1b_config, smi_line)


def decode_batch(eng, n_reqs: int = 32):
    """The packed decode step (ints, floats, shapes) of n_reqs requests of
    256-3136 KV positions."""
    from semi_pd_tpu_torch.runtime.batch import build_decode_batch
    from semi_pd_tpu_torch.runtime.req import Req
    from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams

    runner, sched = eng.runner, eng.scheduler
    rng = np.random.default_rng(0)
    reqs = []
    for i, n in enumerate(rng.integers(256, 3137, size=n_reqs)):
        r = Req(rid=f"t{i}", input_ids=[1] * int(n),
                sampling_params=SamplingParams(temperature=0.0))
        r.req_slot = runner.req_pool.alloc()
        pages = runner.page_allocator.alloc(-(-(int(n) + 8) // 16))
        r.pages = pages.tolist()
        runner.req_pool.write(r.req_slot, 0, pages)
        r.prefilled_len = r.prompt_len
        r.output_ids.append(1)
        reqs.append(r)
    hb = build_decode_batch(reqs, runner.req_pool.page_table, 16, sched.b_buckets,
                            sched.p_buckets)
    return hb.pack()


def trace(label, cfg, kv_cache_dtype):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from semi_pd_tpu_torch.layers.attention import pool_attention
    from semi_pd_tpu_torch.runtime.engine import Engine

    eng = Engine(bench_server_args(False, kv_cache_dtype), cfg)
    runner = eng.runner
    graphs = runner.graphs
    pool = runner.kv_cache.buffer
    packed = decode_batch(eng)
    rows = packed[2][1]

    def step(mode):
        runner.graphs = graphs if mode == "graph" else None
        try:
            runner.step_packed_raw(*packed, is_decode=True)
        finally:
            runner.graphs = graphs

    for name in ("packed", "stream"):
        runner.attention = pool_attention(pool, stream=name == "stream")  # drops the graphs
        stats0 = dict(graphs.stats)
        host = {"eager": [], "graph": []}
        for mode in ("eager", "graph", "graph", "eager"):
            for _ in range(3):
                step(mode)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                step(mode)
            torch.cuda.synchronize()
            host[mode].append(1e3 * (time.perf_counter() - t0) / 20)
        for mode in host:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    step(mode)
                torch.cuda.synchronize()
            ev = [e for e in prof.key_averages() if e.device_time_total > 0]
            device_ms = sum(e.device_time_total for e in ev) / 5 / 1e3
            top = sorted(ev, key=lambda e: -e.device_time_total)[:5]
            print("trace " + json.dumps(dict(
                model=label, kv_cache_dtype=kv_cache_dtype, attention=name,
                decode_graphs=mode == "graph", batch=rows,
                host_ms_per_step=host[mode], device_ms_per_step=device_ms,
                device_busy_share=device_ms / statistics.mean(host[mode]),
                kernels_per_step=sum(e.count for e in ev) / 5,
                captures=graphs.stats["captures"] - stats0["captures"],
                capture_s=graphs.stats["capture_s"] - stats0["capture_s"],
                graph_pool_bytes=graphs.pool_bytes(),
                top_kernels=[dict(name=e.key[:80], per_step=e.count // 5,
                                  device_ms_per_step=e.device_time_total / 5 / 1e3)
                             for e in top])), flush=True)
    del eng.scheduler, eng.runner, runner, graphs
    gc.collect()  # the runner and its graphs refer to each other
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("decode_trace: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from semi_pd_tpu_torch.kernels import build_all

    print("setup " + json.dumps(dict(gpu=smi_line(), build_s=build_all())), flush=True)
    trace("llama-3.2-1b-class", llama_1b_config(), "auto")
    trace("meta-llama-3-8b", llama3_8b_config(), "fp8_e4m3")
    trace("deepseek-v2-lite", deepseek_v2_lite_config(), "auto")
    print(smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
