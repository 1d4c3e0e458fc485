#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (semi_pd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs one CUDA card

It imports nothing of JAX or of the JAX package. Phases, one result line
each (any failure raises and exits non-zero):

1. setup   — the card, the toolchain, and the build of every CUDA kernel
             from semi_pd_tpu_torch/csrc/ (one nvcc per source, in parallel).
2. kernels — each kernel's wrapper on the card against its plain PyTorch
             version on the same inputs, at main-path geometry (Hq 32, Hkv 8,
             D 64, page 16, pool [L, S, 8, 128]), with its time, the plain
             version's time, one PyTorch library call's time
             (scaled_dot_product_attention over pre-gathered dense KV, a
             yardstick the port never calls) and the least time the card
             could take (bytes or operations over the card's peak rates).
3. model   — the full-width Llama-3.2-1B-class model (random weights, seed
             0, 131072-token pool): one extend step and two decode steps
             through the kernels, against the same layers run with the plain
             attention functions.
4. serve   — the Engine with the bench's server settings serves 32 greedy
             requests (prompts 256-3072 tokens, 64 new tokens each),
             colocated and semi-PD; every launch counter is set to 0 just
             before each mode and read just after.

Then one JSON line listing the kernels, the nvidia-smi name/power-limit line,
and the result line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

HQ, HKV, D, PAGE = 32, 8, 64, 16
CT = 2 * HKV * D // 128
SCALE = D ** -0.5

# H100 SXM5 80GB dense peaks (NVIDIA H100 Tensor Core GPU data sheet):
# HBM3 bytes/s, bf16 tensor-core FLOP/s, float32 FLOP/s outside the tensor
# cores.
PEAKS = (3.35e12, 989e12, 67e12)

# Kernel vs plain version: float32 differs only in summation order (online
# vs full softmax); bf16 also rounds P to bf16 before P.V, as the TPU
# kernels do, and has read at most 3.9e-3 at these shapes on an H100.
TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------- phase 2
def make_case(gen, rng, q_lens, kv_lens, dtype):
    """Random pool, queries and a SHUFFLED page table for requests with the
    given new-token and total KV lengths (kv_len 0 = a padded row)."""
    import torch

    from semi_pd_tpu_torch.runtime.forward_batch import build_attn_meta

    B = len(kv_lens)
    n_pages = [-(-k // PAGE) for k in kv_lens]
    maxP = max(max(n_pages), 1)
    total = sum(n_pages) + 1  # + dump page 0
    perm = rng.permutation(np.arange(1, total))
    pt = np.zeros((B, maxP), np.int32)
    used = 0
    for b, n in enumerate(n_pages):
        pt[b, :n] = perm[used:used + n]
        used += n
    dev = "cuda"
    pool = torch.randn((1, total * PAGE, CT, 128), generator=gen, device=dev).to(dtype)
    T = int(sum(q_lens))
    q = torch.randn((T, HQ, D), generator=gen, device=dev).to(dtype)
    meta = build_attn_meta(np.asarray(q_lens), np.asarray(kv_lens), T, device=dev)
    return (q, pool, torch.as_tensor(pt, device=dev),
            torch.as_tensor(np.asarray(kv_lens, np.int32), device=dev), meta)


def dense_kv(pool, pt, kv_lens):
    """[B, Hkv, kvmax, D] K and V gathered for the library yardstick."""
    import torch

    from semi_pd_tpu_torch.ops.attention.rpa_common import gather_kv, layer_kv5

    kv5 = layer_kv5(pool, 0, HKV, D)
    lens = kv_lens.tolist()
    kvmax = max(max(lens), 1)
    B = len(lens)
    K = torch.zeros((B, kvmax, HKV, D), device=pool.device, dtype=pool.dtype)
    V = torch.zeros_like(K)
    for b, n in enumerate(lens):
        if n:
            k, v = gather_kv(kv5, pt[b], n, PAGE)
            K[b, :n], V[b, :n] = k.to(pool.dtype), v.to(pool.dtype)
    return K.transpose(1, 2).contiguous(), V.transpose(1, 2).contiguous(), kvmax


def run_kernel_case(name, kind, gen, rng, q_lens, kv_lens, dtype,
                    cap=None, window=None):
    import torch
    import torch.nn.functional as F

    from semi_pd_tpu_torch.kernels import KERNELS
    from semi_pd_tpu_torch.ops.attention import ragged_paged_attention as rpa
    from semi_pd_tpu_torch.ops.attention import rpa_packed

    q, pool, pt, kvl, meta = make_case(gen, rng, q_lens, kv_lens, dtype)
    kw = dict(page_size=PAGE, num_kv_heads=HKV, head_dim=D, scale=SCALE,
              logit_cap=cap, sliding_window=window)
    if kind == "decode":
        kern = lambda: rpa_packed.ragged_paged_attention_chunked_packed(q, pool, 0, pt, kvl, **kw)
        plain = lambda: rpa_packed.ragged_paged_attention_chunked_packed_plain(q, pool, 0, pt, kvl, **kw)
    else:
        kern = lambda: rpa.ragged_paged_attention_chunked_extend(q, pool, 0, pt, kvl, meta, **kw)
        plain = lambda: rpa.ragged_paged_attention_chunked_extend_plain(q, pool, 0, pt, kvl, meta, **kw)
    out_k = kern()
    torch.cuda.synchronize()
    out_p = plain()
    err = (out_k.float() - out_p.float()).abs()
    tol = TOL[str(dtype).replace("torch.", "")]
    ok = bool((err <= tol + tol * out_p.float().abs()).all()) and bool(torch.isfinite(out_k).all())
    max_err = float(err.max())
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max abs err {max_err:.3g}, tol {tol})")
    counter = KERNELS["rpa_" + kind]
    before = counter.launches
    ms = cuda_ms(kern, 20)
    launches = counter.launches - before + 1  # + the checked call
    plain_ms = cuda_ms(plain, 2)

    # least time: bytes (each input once, output once) vs operations
    esz = q.element_size()
    lens = kvl.tolist()
    ql = meta.q_lens.tolist()
    qs = meta.q_start.tolist()
    if kind == "decode":  # the query sits at n - 1 and sees min(n, window) rows
        kv_rows = pairs = sum(min(n, window) if window else n for n in lens)
    else:
        pairs = kv_rows = 0
        for b in range(len(lens)):
            if not ql[b]:
                continue
            for r in range(ql[b]):
                p = qs[b] + r + 1  # positions visible to this row: [lo, p)
                pairs += p - (max(p - window, 0) if window else 0)
            first = max(qs[b] + 1 - window, 0) if window else 0
            kv_rows += min(lens[b], qs[b] + ql[b]) - first
    flops = 4.0 * pairs * HQ * D
    nbytes = (2 * q.numel() * esz + kv_rows * 2 * HKV * D * esz
              + pt.numel() * 4 + kvl.numel() * 4)
    bw, bf16_peak, f32_peak = PEAKS
    t_bytes = nbytes / bw * 1e3
    t_ops = flops / (bf16_peak if dtype == torch.bfloat16 else f32_peak) * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"

    library_ms = None
    if cap is None:
        K, V, kvmax = dense_kv(pool, pt, kvl)
        B = len(lens)
        if kind == "decode":
            qd = q[:, :, None, :]  # [B, Hq, 1, D]
            pos = torch.arange(kvmax, device="cuda")[None, :]
            n = kvl[:, None].long()
            mask = pos < n
            if window:
                mask &= pos >= n - window
            mask = mask[:, None, None, :]
        else:
            qmax = max(ql)
            qd = torch.zeros((B, HQ, qmax, D), device="cuda", dtype=q.dtype)
            rows = torch.arange(qmax, device="cuda")
            mask = torch.zeros((B, 1, qmax, kvmax), device="cuda", dtype=torch.bool)
            off = 0
            pos = torch.arange(kvmax, device="cuda")[None, :]
            for b in range(B):
                qd[b, :, : ql[b]] = q[off: off + ql[b]].transpose(0, 1)
                qa = qs[b] + rows[:, None]
                m = (pos <= qa) & (pos < lens[b]) & (rows[:, None] < ql[b])
                if window:
                    m &= pos > qa - window
                mask[b, 0] = m
                off += ql[b]
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qd, K, V, attn_mask=mask, scale=SCALE, enable_gqa=True), 20)
    row = dict(case=name, kernel=kind, dtype=str(dtype).replace("torch.", ""),
               max_abs_err=max_err, kernel_ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
               launches=launches)
    print("kernel_case " + json.dumps(row), flush=True)
    del q, pool
    torch.cuda.empty_cache()
    return row


def phase_kernels():
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rng = np.random.default_rng(0)
    bf, f32 = torch.bfloat16, torch.float32
    rows = []

    def ragged(b, kv):
        lens = rng.integers(kv // 2, kv + 1, size=b)
        lens[0] = kv
        lens[-1] = 0  # one padded row
        return lens.tolist()

    for b, kv in ((16, 8192), (64, 1024), (128, 2048)):
        lens = ragged(b, kv)
        for dt in (bf, f32):
            rows.append(run_kernel_case(f"decode_b{b}_kv{kv}", "decode", gen, rng,
                                        [1] * b, lens, dt))
    ext = {"extend_b8_q256_kv2048": ([256] * 8, [2048] * 8),
           "extend_ragged_kv1024": ([512, 256, 128, 64, 384, 448, 192, 64], [1024] * 8)}
    for name, (ql, kl) in ext.items():
        for dt in (bf, f32):
            rows.append(run_kernel_case(name, "extend", gen, rng, ql, kl, dt))
    # softcap 1.0: scores q.k * D**-0.5 have std ~1 here, so the cap bends
    # most of them (tanh(2) = 0.96) and a kernel that ignored it would fail
    dec = ("decode", [1] * 16, ragged(16, 2048), "decode_b16_kv2048")
    ext = ("extend", [256] * 8, [2048] * 8, "extend_b8_q256_kv2048")
    for kind, ql, kl, base in (dec, ext):
        for dt in (bf, f32):
            rows.append(run_kernel_case(f"{base}_softcap1", kind, gen, rng, ql, kl, dt,
                                        cap=1.0))
            rows.append(run_kernel_case(f"{base}_window512", kind, gen, rng, ql, kl, dt,
                                        window=512))
    return rows


# --------------------------------------------------------------- phase 3/4
def llama_1b_config():
    from semi_pd_tpu_torch.config.model_config import ModelConfig

    return ModelConfig(
        architecture="LlamaForCausalLM", vocab_size=128256, hidden_size=2048,
        intermediate_size=8192, num_hidden_layers=16, num_attention_heads=32,
        num_key_value_heads=8, head_dim=64, max_position_embeddings=8192,
        context_length=8192, rope_theta=500000.0, dtype="bfloat16",
    )


def bench_server_args(semi_pd: bool):
    """The bench's server settings (bench.py make_server_args) with a
    131072-token pool."""
    from semi_pd_tpu_torch.config.server_args import ServerArgs

    return ServerArgs(
        random_weights=True, seed=0, page_size=16, max_total_tokens=131072,
        chunked_prefill_size=4096, enable_semi_pd=semi_pd, decode_slo_ms=50.0,
        max_running_requests=64, decode_bs_buckets=[8, 32, 64],
        prefill_token_buckets=[512, 2048, 4096],
    )


def phase_model(eng):
    """One extend step + two decode steps at full width, kernels vs the same
    layers with the plain attention functions."""
    import torch

    from semi_pd_tpu_torch.ops.attention.ragged_paged_attention import (
        ragged_paged_attention_chunked_plain,
    )
    from semi_pd_tpu_torch.runtime.batch import build_decode_batch, build_extend_batch
    from semi_pd_tpu_torch.runtime.req import Req
    from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams

    runner = eng.runner
    sched = eng.scheduler
    rng = np.random.default_rng(1)
    reqs = []
    for i, n in enumerate((700, 300, 1500, 37)):
        r = Req(rid=f"m{i}", input_ids=rng.integers(0, 128256, size=n).tolist(),
                sampling_params=SamplingParams(temperature=0.0))
        r.req_slot = runner.req_pool.alloc()
        pages = runner.page_allocator.alloc(-(-(n + 8) // PAGE))
        r.pages = pages.tolist()
        runner.req_pool.write(r.req_slot, 0, pages)
        reqs.append(r)
    pool = runner.kv_cache.buffer
    model = runner.model
    worst = 0.0
    steps = []
    with torch.inference_mode():
        hb = build_extend_batch([(r, r.prompt_len) for r in reqs], runner.req_pool.page_table,
                                PAGE, sched.t_buckets, sched.b_buckets, sched.p_buckets)
        for step in range(3):
            fb = hb.to_device(runner.device)
            lk = model(fb, pool)
            lp = model(fb, pool, attention=ragged_paged_attention_chunked_plain)
            n = len(reqs)
            lk, lp = lk[:n].float(), lp[:n].float()
            if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
                raise AssertionError(f"model step {step}: non-finite logits")
            rel = float((lk - lp).abs().max() / lp.abs().max())
            agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
            worst = max(worst, rel)
            steps.append(dict(mode=hb.mode.value, T=hb.T, rel_err=rel, argmax_agree=agree))
            toks = lk.argmax(-1).tolist()
            for r, t in zip(reqs, toks):
                if step == 0:
                    r.prefilled_len = r.prompt_len
                r.output_ids.append(int(t))
            hb = build_decode_batch(reqs, runner.req_pool.page_table, PAGE,
                                    sched.b_buckets, sched.p_buckets)
    torch.cuda.synchronize()
    for r in reqs:
        runner.page_allocator.free(np.asarray(r.pages, np.int32))
        runner.req_pool.free(r.req_slot)
    # bf16 tolerance: the two paths differ only in attention (the kernel
    # rounds P to bf16 before P.V and sums in another order); over 16 layers
    # that stays within 5% of the logit range
    if worst > 0.05:
        raise AssertionError(f"full-width logits: kernels vs plain rel err {worst:.3g} > 0.05")
    return dict(steps=steps, worst_rel_err=worst)


def serve_mode(eng, semi_pd: bool, prompts, vocab):
    import torch

    from semi_pd_tpu_torch.kernels import KERNELS
    from semi_pd_tpu_torch.runtime.scheduler import Scheduler
    from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams

    args = bench_server_args(semi_pd)
    if not eng.flush_cache():
        raise AssertionError("engine not idle before serving")
    eng.server_args = args
    eng.scheduler = Scheduler(args, eng.runner)
    sp = SamplingParams(max_new_tokens=64, temperature=0.0, ignore_eos=True)
    runner = eng.runner
    runner.step_counts = {"decode": 0, "extend": 0}
    for k in KERNELS.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    outs = eng.generate(input_ids=prompts, sampling_params=sp, return_logprob=True)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {name: k.launches for name, k in KERNELS.items()}
    steps = dict(runner.step_counts)
    reqs = [eng.scheduler.reqs_by_rid[o["rid"]] for o in outs]
    for o in outs:
        if o["meta_info"]["finish_reason"] != "length" or len(o["output_ids"]) != 64:
            raise AssertionError(f"request {o['rid']} did not complete: {o['meta_info']['finish_reason']}")
        lps = o["meta_info"]["output_logprobs"]
        if len(lps) != 64 or not all(math.isfinite(x) for x in lps):
            raise AssertionError(f"request {o['rid']}: missing or NaN logprobs")
        if not all(0 <= t < vocab for t in o["output_ids"]):
            raise AssertionError(f"request {o['rid']}: token out of range")
    L = eng.runner.model_config.num_hidden_layers
    if launches["rpa_decode"] != L * steps["decode"] or steps["decode"] == 0:
        raise AssertionError(f"decode launches {launches['rpa_decode']} != {L} x {steps['decode']} steps")
    if launches["rpa_extend"] != L * steps["extend"] or steps["extend"] == 0:
        raise AssertionError(f"extend launches {launches['rpa_extend']} != {L} x {steps['extend']} steps")
    if not eng.flush_cache():  # runs check_memory()
        raise AssertionError("engine not idle after serving")
    ttft = [r.first_token_time - r.queue_time for r in reqs]
    itl = [(r.finish_time - r.first_token_time) / (len(r.output_ids) - 1) for r in reqs]
    res = dict(mode="semi_pd" if semi_pd else "colocated", requests=len(outs),
               wall_s=wall, tok_s=len(outs) * 64 / wall,
               ttft_p50_s=statistics.median(ttft), itl_p50_ms=1e3 * statistics.median(itl),
               steps=steps, launches=launches,
               retracted=eng.scheduler.n_retracted)
    return res, [o["output_ids"] for o in outs]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke run needs a GPU",
              file=sys.stderr)
        return 2
    from semi_pd_tpu_torch.kernels import KERNELS, build_all, find_nvcc
    from semi_pd_tpu_torch.runtime.engine import Engine

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 checks in full float32
    torch.backends.cudnn.allow_tf32 = False

    # 1. setup
    t0 = time.monotonic()
    smi = smi_line()
    name = torch.cuda.get_device_name(0)
    nvcc = subprocess.run([find_nvcc(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    build_s = build_all()
    ptxas = [ln.strip() for k in KERNELS.values() for ln in k.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    for ln in ptxas:
        print("ptxas " + ln)
    print("setup " + json.dumps(dict(
        gpu=smi, kind=name, torch=torch.__version__,
        cuda=torch.version.cuda, nvcc=nvcc[-1] if nvcc else None,
        python=sys.version.split()[0], build_s=build_s,
        seconds=time.monotonic() - t0)), flush=True)

    # 2. kernels against their plain versions
    t0 = time.monotonic()
    rows = phase_kernels()
    print("kernels_phase " + json.dumps(dict(cases=len(rows), seconds=time.monotonic() - t0)),
          flush=True)

    # 3. full-width model
    t0 = time.monotonic()
    cfg = llama_1b_config()
    eng = Engine(bench_server_args(False), cfg)
    init_s = time.monotonic() - t0
    res = phase_model(eng)
    print("model " + json.dumps(dict(res, init_s=init_s, seconds=time.monotonic() - t0)),
          flush=True)

    # 4. serving, both modes
    t0 = time.monotonic()
    rng = np.random.default_rng(0)
    lens = rng.integers(256, 3073, size=32)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist() for n in lens]
    main_launches = {k: 0 for k in KERNELS}
    outputs = {}
    for semi in (False, True):
        r, outputs[semi] = serve_mode(eng, semi, prompts, cfg.vocab_size)
        for k, v in r["launches"].items():
            main_launches[k] += v
        print("serve " + json.dumps(dict(r, gpu=smi)), flush=True)
    same = np.mean([a == b for a, b in zip(outputs[False], outputs[True])])
    print("serve_phase " + json.dumps(dict(
        modes_same_tokens=float(same), seconds=time.monotonic() - t0)), flush=True)

    # 5. the kernels line: representative main-path cases (bf16)
    rep = {"rpa_decode": "decode_b64_kv1024", "rpa_extend": "extend_b8_q256_kv2048"}
    kind = {"rpa_decode": "decode", "rpa_extend": "extend"}
    kernels = []
    for kname, k in KERNELS.items():
        row = next(r for r in rows if r["case"] == rep[kname] and r["dtype"] == "bfloat16")
        errs = [r["max_abs_err"] for r in rows if r["kernel"] == kind[kname]]
        kernels.append(dict(
            name=kname, route="cuda", source=k.source_rel, replaces=k.replaces,
            launches=main_launches[kname], max_abs_err=max(errs),
            ms=row["kernel_ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
