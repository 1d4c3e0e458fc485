"""Static one-batch latency benchmark CLI (port of
semi_pd_tpu/bench_one_batch.py).

A fixed batch of random prompts (seed 0) through the port's Engine: it
reports prefill latency, decode latency and throughput as one JSON line.
It runs on the CUDA card (decode steps replayed from CUDA graphs, captured
by the warm-up generation) unless ``--device cpu`` is given. Without
``--model-path`` the model is the Llama-3.2-1B-class geometry at
``--bench-layers`` layers with random weights.

Usage:
  python -m semi_pd_tpu_torch.bench_one_batch [--random-weights]
      --batch-size 8 --input-len 512 --output-len 32 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def llama_1b_class_config(layers: int = 16):
    """The JAX bench's model (``_llama_config``): Llama-3.2-1B-class widths,
    GQA 32/8 at head_dim 64, bf16."""
    from semi_pd_tpu_torch.config.model_config import ModelConfig

    return ModelConfig(
        architecture="LlamaForCausalLM", vocab_size=128256, hidden_size=2048,
        intermediate_size=8192, num_hidden_layers=layers, num_attention_heads=32,
        num_key_value_heads=8, head_dim=64, max_position_embeddings=8192,
        context_length=8192, rope_theta=500000.0, dtype="bfloat16",
    )


def main(argv=None, model_config=None):
    """``model_config``: the model to run (default: the 1B-class geometry at
    ``--bench-layers`` layers)."""
    p = argparse.ArgumentParser()
    p.add_argument("--model-path", default="")
    p.add_argument("--random-weights", action="store_true")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--input-len", type=int, default=512)
    p.add_argument("--output-len", type=int, default=32)
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--max-total-tokens", type=int, default=None)
    p.add_argument("--quantization", default=None)
    p.add_argument("--bench-layers", type=int, default=16)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    from semi_pd_tpu_torch.config.server_args import ServerArgs
    from semi_pd_tpu_torch.runtime.engine import Engine
    from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams

    sa = ServerArgs(
        model_path=args.model_path,
        random_weights=args.random_weights or not args.model_path,
        page_size=args.page_size,
        max_total_tokens=args.max_total_tokens
        or (args.batch_size * (args.input_len + args.output_len) + 4096),
        chunked_prefill_size=max(args.input_len * args.batch_size, 2048),
        device=args.device,
        quantization=args.quantization,
    )
    if model_config is None:
        model_config = llama_1b_class_config(args.bench_layers)
    eng = Engine(server_args=sa, model_config=model_config, device=args.device)
    vocab = model_config.vocab_size

    rng = np.random.default_rng(0)
    prompts = [
        rng.integers(10, min(1000, vocab), size=args.input_len).tolist()
        for _ in range(args.batch_size)
    ]
    sp = SamplingParams(
        max_new_tokens=args.output_len, temperature=0.0, ignore_eos=True
    )

    # Warm-up (builds the kernels, captures the decode batch's graph)
    eng.generate(input_ids=prompts, sampling_params=SamplingParams(
        max_new_tokens=2, temperature=0.0, ignore_eos=True))

    # Timed run: prefill until the first token, then decode, by tick timing
    reqs = [eng.make_request(input_ids=pr, sampling_params=sp) for pr in prompts]
    for r in reqs:
        eng.scheduler.add_request(r)
    t0 = time.monotonic()
    t_first = None
    n_tokens = 0
    while eng.scheduler.has_work():
        produced = eng.scheduler.tick()
        for req, tok in produced:
            if tok >= 0:
                n_tokens += 1
                if t_first is None:
                    t_first = time.monotonic()
    t_end = time.monotonic()

    prefill_lat = (t_first - t0) if t_first else 0.0
    decode_time = t_end - (t_first or t0)
    decode_tokens = n_tokens - args.batch_size
    out = {
        "batch_size": args.batch_size,
        "input_len": args.input_len,
        "output_len": args.output_len,
        "prefill_latency_s": round(prefill_lat, 4),
        "prefill_throughput_tok_s": round(
            args.batch_size * args.input_len / max(prefill_lat, 1e-9), 1
        ),
        "median_decode_latency_s": round(
            decode_time / max(args.output_len - 1, 1), 5
        ),
        "decode_throughput_tok_s": round(
            decode_tokens / max(decode_time, 1e-9), 1
        ),
        "total_throughput_tok_s": round(n_tokens / (t_end - t0), 1),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
